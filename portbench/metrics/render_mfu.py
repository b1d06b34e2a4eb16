"""render_mfu: the render's share of the card's peak, in %: the frozen
streamed-basis count of a view (counts/<config>.py::render_flops_per_view,
encode and basis planes included) times the views of the measured window,
over the window's seconds and the dtype's published peak."""

from portbench.counts.peaks import peak_flops


def read(run):
    w, cell = run.window, run.cell
    if not w["attempted"]:
        return None
    views = cell.mix["n_theta"] * cell.mix["n_phi"]
    flops = cell.counts().render_flops_per_view(views, cell.lead_num) * views * cell.mix["batch"]
    return 100.0 * flops * w["attempted"] / w["seconds"] / peak_flops(cell.dtype)
