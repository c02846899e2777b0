from .registry import create_model, get_model, register_model  # noqa: F401
from . import unet3d  # noqa: F401  (registers ddpm_res64 / ddpm_res128)
from . import dit3d  # noqa: F401  (registers dit3d_xl4)
from . import flux3d  # noqa: F401  (registers flux3d)
