from volumetric_renderer.transfer.gradient import Gradient
from volumetric_renderer.transfer.texture import sample_tf

__all__ = ["Gradient", "sample_tf"]
