"""PyTorch/CUDA port of Electrocardio-Panorama (Nef-Net) for NVIDIA Hopper.

A second package beside the JAX reference `electrocardio_panorama_tpu`, with
the same layout (config/, data/, ops/, models/, training/, synthesis.py,
render.py), the same configs and the same torch-keyed pickle checkpoints. It
imports torch and never jax or the JAX package. The TPU's Pallas kernels
become hand-written CUDA kernels under `ops/kernels/`; each keeps a plain
PyTorch version beside it, which is what a CPU tensor runs.

Entry points run on `cuda` unless the caller asks for the CPU
(`device="cpu"` / `--device cpu`), and fail loudly when no GPU is present.
"""

__version__ = "0.1.0"

from electrocardio_panorama_tpu_torch.config import get_cfg, load_cfg  # noqa: E402,F401
