"""Sharded optimization loops: TF-fit and voxel-grid inversion.

BASELINE configs 3-4: recover a transfer function (or the whole density
grid) from target images by pixel-loss gradient descent.  These are the
north-star capabilities the reference lacks entirely — its TF editing is a
human dragging markers (``src/ui/components/gradient.cpp:134-469``); here
the TF table and the grid are parameters of a differentiable renderer.

Sharding: pixels/tiles over the mesh (forward communication-free),
grid/TF gradients all-reduced inside the marcher's custom VJP (psum, which
XLA hands to NCCL on GPUs).

``row_layout="cyclic"`` (or a tile layout) trains on shard-ordered images
— the loss permutes the *targets* to match (a free static gather on
replicated data), so the forward stays collective-free.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax

from volumetric_renderer.parallel.mesh import make_layout
from volumetric_renderer.parallel.render import make_sharded_renderer
from volumetric_renderer.utils.config import RenderSettings


class TrainState(NamedTuple):
    params: dict          # {"vol": (Z,Y,X)?, "tf": (N,4)?} — what's optimized
    opt_state: optax.OptState
    step: jnp.ndarray


def make_train_step(mesh, settings: RenderSettings, optimizer,
                    *, optimize_vol: bool, optimize_tf: bool,
                    method: str = "auto", interpret: bool = False,
                    row_layout: str = "contiguous"):
    """Build ``(state, fixed, cameras, targets) -> (state, loss)``.

    ``cameras`` is an ``OrbitCamera`` pytree with a leading batch axis (one
    entry per posed view; batch=1 for TF-fit).  ``targets`` is
    ``(V, H, W, 4)``.  ``fixed`` carries whichever of vol/tf is not being
    optimized plus the density window.  Views are looped over (grid
    gradients accumulate across views); pixels within a view are
    mesh-sharded.  ``method`` and ``interpret`` are as in
    :func:`~volumetric_renderer.parallel.render.make_sharded_renderer`.
    """
    h, w = settings.height, settings.width
    shardorder = row_layout != "contiguous"
    if shardorder:
        # train on shard-order images: targets are packed with the same
        # static gather (free on replicated data) and padded positions are
        # masked out of the loss, so the forward stays collective-free
        _, _, pack_img, _, valid = make_layout(row_layout, h, w, mesh.size)
        vmask = valid[..., None]

    render_fn = make_sharded_renderer(mesh, settings, method,
                                      interpret=interpret,
                                      row_layout=row_layout,
                                      permuted_output=shardorder)

    def loss_fn(params, fixed, cameras, targets):
        vol = params["vol"] if optimize_vol else fixed["vol"]
        tf = params["tf"] if optimize_tf else fixed["tf"]

        def one_view(i, carry):
            cam = jax.tree.map(lambda x: x[i], cameras)
            target = targets[i]
            img = render_fn(vol, tf, cam, fixed["dmin"], fixed["dmax"],
                            fixed["smin"], fixed["smax"])
            if shardorder:
                sq = ((img - pack_img(target)) ** 2) * vmask
                return carry + jnp.sum(sq) / float(h * w * 4)
            return carry + jnp.mean((img - target) ** 2)

        total = jax.lax.fori_loop(0, targets.shape[0], one_view,
                                  jnp.float32(0.0))
        return total / targets.shape[0]

    @jax.jit
    def train_step(state: TrainState, fixed, cameras, targets):
        loss, grads = jax.value_and_grad(loss_fn)(
            state.params, fixed, cameras, targets)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        params = optax.apply_updates(state.params, updates)
        if optimize_tf:
            # keep the TF a physical RGBA table (matches the reference's
            # unorm texture range, offscreen_pass.cpp:1076)
            params = dict(params, tf=jnp.clip(params["tf"], 0.0, 1.0))
        if optimize_vol:
            params = dict(params, vol=jnp.maximum(params["vol"], 0.0))
        return TrainState(params, opt_state, state.step + 1), loss

    return train_step


def init_state(optimizer, params: dict) -> TrainState:
    return TrainState(params, optimizer.init(params), jnp.int32(0))
