"""Device mesh construction.

The reference is strictly single-device (SURVEY.md §2.4): its only
parallelism is the GPU rasterizer marching every fragment independently
(``res/shaders/volume.frag:21-51``).  Here that per-pixel independence
becomes the shardable axis: pixel tiles are distributed over a
``jax.sharding.Mesh`` and each card marches its pixels, with the gradient
all-reduce (``psum``) over the mesh handed to NCCL.  Every card of a host
reaches every other over NVLink at the same rate, so the mesh is a plain
device list shaped by the algorithm alone.

Axis conventions:
  * ``"tiles"`` — the data-parallel pixel/ray axis (image rows).
  * ``"hosts"`` (optional, 2D mesh) — outer axis for multi-host runs;
    grid gradients reduce hierarchically (NVLink within a host, the
    network across hosts).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

TILE_AXIS = "tiles"
HOST_AXIS = "hosts"

# Pixel-to-device layouts understood by make_layout (CLI surfaces derive
# their choices from this so new layouts appear everywhere at once).
LAYOUTS = ("contiguous", "cyclic", "tile-cyclic", "tile-shuffle")


def make_mesh(devices: Optional[Sequence[jax.Device]] = None,
              shape: Optional[Tuple[int, ...]] = None,
              axis_names: Optional[Tuple[str, ...]] = None) -> Mesh:
    """Build a mesh over ``devices`` (default: all addressable devices).

    Default: a 1D mesh over every device on the ``"tiles"`` axis.  Pass
    ``shape=(hosts, chips)`` and ``axis_names=("hosts", "tiles")`` for an
    explicit 2D multi-host layout.
    """
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices)
    if shape is None:
        shape = (devices.size,)
    if axis_names is None:
        axis_names = (TILE_AXIS,) if len(shape) == 1 else (HOST_AXIS, TILE_AXIS)
    return Mesh(devices.reshape(shape), axis_names)


def tile_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for ``(H, W, ...)`` images: rows split over every mesh axis."""
    return NamedSharding(mesh, P(mesh.axis_names))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_rows(h: int, mesh: Mesh) -> int:
    """Rows after padding ``h`` up to a multiple of the mesh size."""
    n = mesh.size
    return -(-h // n) * n


def make_layout(layout: str, h: int, w: int, n_dev: int, tile: int = 16):
    """Pixel-to-device distribution for the sharded renderer.

    Returns ``(gh, gw, pack, unpack, valid)``:

    * ``gh, gw`` — the global image shape fed through ``shard_map``
      (``gh`` rows split contiguously over ``n_dev`` devices; each device
      hands its ``(gh/n_dev, gw)`` block to the marcher).
    * ``pack(img)`` — ``(h, w, C) -> (gh, gw, C)`` static rearrangement
      into shard order (zero-filled padding); a free gather on replicated
      data.
    * ``unpack(x)`` — the exact inverse, ``(gh, gw, C) -> (h, w, C)``.
    * ``valid`` — ``(gh, gw)`` float32 mask of true pixels (0 on padding),
      for loss masking and for making padded rays inert.

    Layouts:

    * ``"contiguous"`` — device d owns rows ``[d*h/n, (d+1)*h/n)``.
      Simplest; load-imbalanced when the subject sits mid-frame.
    * ``"cyclic"`` — 16-row blocks round-robin over devices (blocks match
      the march kernel's tile height, so intra-tile ray coherence is
      untouched).  Balanced to ~the per-block cost quantum.
    * ``"tile-cyclic"`` — 16x16 tiles round-robin over devices in raster
      order; each shard is handed a ``(T*16/n, 16)`` tile-column image —
      the kernel tiles it back into exactly the original 16x16 tiles, so
      per-tile windows are identical to the unsharded render.  ~100x
      finer balance quantum than "cyclic" (a tile, not a row of tiles).
    * ``"tile-shuffle"`` — tile-cyclic after a fixed seeded permutation
      of the tile order.  Raster-order round-robin keeps a spatial
      stride-n correlation (device d always gets the same columns-mod-n
      of every tile row); shuffling decorrelates it.
    """
    if layout == "contiguous":
        gh = -(-h // n_dev) * n_dev

        def pack(img):
            pad = ((0, gh - h),) + ((0, 0),) * (img.ndim - 1)
            return jnp.pad(img, pad)

        def unpack(x):
            return x[:h]

        valid = np.zeros((gh, w), np.float32)
        valid[:h] = 1.0
        return gh, w, pack, unpack, jnp.asarray(valid)
    elif layout == "cyclic":
        gh, perm, _ = cyclic_row_layout(h, n_dev, tile)
    elif layout in ("tile-cyclic", "tile-shuffle"):
        ht, wt = -(-h // tile), -(-w // tile)
        tp = -(-(ht * wt) // n_dev) * n_dev
        idx = np.arange(tp)
        if layout == "tile-shuffle":
            idx = np.random.Generator(np.random.PCG64(0)).permutation(tp)
        order = np.concatenate([idx[d::n_dev] for d in range(n_dev)])
        gh, gw = tp * tile, tile

        def pack(img):
            c = img.shape[2:]
            x = jnp.zeros((ht * tile, wt * tile) + c, img.dtype)
            x = x.at[:h, :w].set(img)
            x = x.reshape((ht, tile, wt, tile) + c)
            x = jnp.moveaxis(x, 2, 1).reshape((ht * wt, tile, tile) + c)
            if tp > ht * wt:
                x = jnp.concatenate(
                    [x, jnp.zeros((tp - ht * wt, tile, tile) + c,
                                  img.dtype)])
            x = jnp.take(x, jnp.asarray(order), axis=0)
            return x.reshape((tp * tile, tile) + c)

        def unpack(x):
            c = x.shape[2:]
            x = x.reshape((tp, tile, tile) + c)
            x = jnp.take(x, jnp.asarray(np.argsort(order)), axis=0)
            x = x[:ht * wt].reshape((ht, wt, tile, tile) + c)
            x = jnp.moveaxis(x, 1, 2).reshape((ht * tile, wt * tile) + c)
            return x[:h, :w]

        valid = np.asarray(pack(jnp.ones((h, w), np.float32)))
        return gh, gw, pack, unpack, jnp.asarray(valid)
    else:
        raise ValueError(f"unknown row_layout {layout!r}")

    inv = np.argsort(perm)

    def pack(img):
        pad = ((0, gh - h),) + ((0, 0),) * (img.ndim - 1)
        return jnp.take(jnp.pad(img, pad), jnp.asarray(perm), axis=0)

    def unpack(x):
        return jnp.take(x, jnp.asarray(inv), axis=0)[:h]

    valid = np.zeros((gh, w), np.float32)
    valid[perm < h] = 1.0
    return gh, w, pack, unpack, jnp.asarray(valid)


def cyclic_row_layout(h: int, n_dev: int, block: int = 16):
    """Block-cyclic row assignment for load balance.

    A contiguous band split gives each chip one horizontal strip of the
    frame; the strip containing the subject then becomes the critical
    path (the volume sits mid-frame under the orbit camera) and scaling
    efficiency collapses to ~t_subject_band/t_mean.  Assigning 16-row
    blocks round-robin instead gives every chip a uniform sample of the
    frame — ``block=16`` matches the march kernel's tile height so ray
    coherence inside each 16x16 tile is untouched.

    Returns ``(hp, perm, inv)``: rows after padding to a multiple of
    ``block * n_dev``, the permutation such that ``img[perm]`` is
    shard-order (device d owns blocks d, d+n, d+2n, ...), and its
    inverse (``img_shardorder[inv] == img``).
    """
    hp = -(-h // (block * n_dev)) * (block * n_dev)
    n_blocks = hp // block
    order = np.concatenate(
        [np.arange(d, n_blocks, n_dev) for d in range(n_dev)])
    perm = (order[:, None] * block + np.arange(block)[None, :]).reshape(-1)
    inv = np.argsort(perm)
    return hp, perm, inv
