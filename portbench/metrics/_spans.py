"""Shared by the readers of the program's spans
(electrocardio_panorama_tpu_torch/utils/profiling.py): a span's sum over the
traced window, per step or request. The program records spans while a
torch.profiler session is active, so the recorder holds those of the traced
window alone; a program without the recorder reads nothing."""

TRAIN_ROOT = "ecgpan.train_step"
RENDER_ROOT = "ecgpan.render"


def per_root(run, name: str, root: str, field: str):
    """`field` ('host_ms' or 'device_ms') of the span `name`, summed over the
    traced window, over the number of root spans named `root` (the steps or
    requests). None without a trace, a recorder, a root or the field."""
    if run.trace is None:
        return None
    from electrocardio_panorama_tpu_torch.utils import profiling

    snapshot = getattr(profiling, "snapshot", None)
    if snapshot is None:
        return None
    snap = snapshot()
    roots = sum(1 for s in snap["spans"] if s["parent"] is None and s["name"] == root)
    got = snap["by_name"].get(name, {}).get(field)
    if not roots or got is None:
        return None
    return float(got) / roots
