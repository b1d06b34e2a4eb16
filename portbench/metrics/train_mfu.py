"""train_mfu: the train step's share of the card's peak, in %: the frozen
operation count of a step (counts/<config>.py) times the steps of the
measured window, over the window's seconds and the dtype's published peak."""

from portbench.counts.peaks import peak_flops


def read(run):
    w, cell = run.window, run.cell
    if not w["attempted"]:
        return None
    flops = cell.counts().train_step_flops(cell.mix["batch"], cell.lead_num)
    return 100.0 * flops * w["attempted"] / w["seconds"] / peak_flops(cell.dtype)
