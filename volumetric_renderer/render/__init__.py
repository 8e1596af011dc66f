from volumetric_renderer.render.api import (
    render,
    render_loss_and_grads,
    composite_over,
)

__all__ = ["render", "render_loss_and_grads", "composite_over"]
