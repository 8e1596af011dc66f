from volumetric_renderer.core.sampling import trilinear_sample
from volumetric_renderer.core.marcher import march_rays, render_oracle

__all__ = ["trilinear_sample", "march_rays", "render_oracle"]
