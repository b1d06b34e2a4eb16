"""Beat annotation: the six-key breakpoint schema, automatic P/QRS/T
segmentation and the annotate CLI (`python -m
electrocardio_panorama_tpu_torch.annotation.cli`). numpy and scipy only;
matplotlib is imported inside `plot`, `annotate` and `interactive.py`."""

from electrocardio_panorama_tpu_torch.annotation.auto_segment import auto_segment, detect_r_peaks
from electrocardio_panorama_tpu_torch.annotation.schema import (
    BREAKPOINT_KEYS,
    beats_in,
    load_breakpoints,
    read_ecg_txt,
    save_breakpoints,
    validate_breakpoints,
)

__all__ = [
    "BREAKPOINT_KEYS",
    "read_ecg_txt",
    "load_breakpoints",
    "save_breakpoints",
    "validate_breakpoints",
    "beats_in",
    "auto_segment",
    "detect_r_peaks",
]
