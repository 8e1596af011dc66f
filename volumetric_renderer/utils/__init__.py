from volumetric_renderer.utils.config import RenderSettings
from volumetric_renderer.utils import quaternion
from volumetric_renderer.utils import color

__all__ = ["RenderSettings", "quaternion", "color"]
