from electrocardio_panorama_tpu_torch.utils.device import resolve_device
from electrocardio_panorama_tpu_torch.utils.seeding import seed_everything
from electrocardio_panorama_tpu_torch.utils.writer import ScalarWriter

__all__ = ["resolve_device", "seed_everything", "ScalarWriter"]
