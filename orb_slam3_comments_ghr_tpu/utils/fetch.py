"""Single-round-trip device->host fetch for arbitrary pytrees.

`jax.device_get` on a pytree issues one host transfer PER LEAF, each with
its own synchronization, so fetching a 10-leaf result costs 10 transfers.
`device_fetch` packs all leaves into ONE uint32 buffer on device (bitcast is
lossless for every 32-bit dtype), transfers once, and unpacks on the host.

The packer is a tiny jitted program cached per (treedef, shapes, dtypes);
its dispatch is asynchronous and costs microseconds.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

_PACKER_CACHE: dict = {}


def _promote32(x):
    """Cast sub-32-bit / bool leaves up to a 32-bit dtype (recorded so the
    host side can cast back)."""
    if x.dtype == jnp.bool_:
        return x.astype(jnp.uint32)
    if x.dtype.itemsize < 4:
        kind = x.dtype.kind
        return x.astype(jnp.int32 if kind == "i" else jnp.uint32)
    if x.dtype == jnp.float64:
        return x.astype(jnp.float32)
    if x.dtype in (jnp.int64, jnp.uint64):
        return x.astype(jnp.int32 if x.dtype == jnp.int64 else jnp.uint32)
    return x


def _wire_dtype(d):
    """numpy dtype a leaf travels as after _promote32 + bitcast round trip."""
    d = np.dtype(d)
    if d == np.bool_:
        return np.dtype(np.uint32)
    if d.itemsize < 4:
        return np.dtype(np.int32 if d.kind == "i" else np.uint32)
    if d == np.float64:
        return np.dtype(np.float32)
    if d == np.int64:
        return np.dtype(np.int32)
    if d == np.uint64:
        return np.dtype(np.uint32)
    return d


def _make_packer(n_leaves):
    @jax.jit
    def pack(*leaves):
        parts = []
        for x in leaves:
            x = _promote32(jnp.asarray(x))
            parts.append(jax.lax.bitcast_convert_type(x, jnp.uint32).ravel())
        return jnp.concatenate(parts) if parts else jnp.zeros(0, jnp.uint32)

    return pack


def _pack(tree):
    """Pack a pytree into one device uint32 buffer; returns (buf, leaves,
    treedef)."""
    leaves, treedef = jax.tree.flatten(tree)
    sig = (treedef, tuple((jnp.shape(x), str(jnp.asarray(x).dtype)) for x in leaves))
    entry = _PACKER_CACHE.get(sig)
    if entry is None:
        entry = _make_packer(len(leaves))
        _PACKER_CACHE[sig] = entry
    return entry(*leaves), leaves, treedef


def _unpack(buf: np.ndarray, leaves, treedef):
    out = []
    off = 0
    for x in leaves:
        shape = jnp.shape(x)
        n = int(np.prod(shape)) if shape else 1
        orig = np.dtype(jnp.asarray(x).dtype)
        seg = buf[off : off + n].view(_wire_dtype(orig)).reshape(shape)
        off += n
        if orig == np.bool_:
            seg = seg.astype(bool)
        elif seg.dtype != orig and orig.itemsize < 4:
            seg = seg.astype(orig)
        out.append(seg)
    return jax.tree.unflatten(treedef, out)


def device_fetch(tree):
    """Fetch a pytree of (device or host) arrays as numpy with ONE device
    round trip. Original dtypes are restored (f64/i64 leaves come back as
    their 32-bit counterparts — device arrays are 32-bit under default jax
    config anyway)."""
    leaves, _ = jax.tree.flatten(tree)
    if not leaves:
        return tree
    buf, leaves, treedef = _pack(tree)
    return _unpack(np.asarray(buf), leaves, treedef)


class AsyncFetch:
    """In-flight device->host fetch: the transfer was started with
    `copy_to_host_async`; `get()` blocks only for whatever remains of the
    producing computation and the copy. Started at dispatch and harvested a
    few frames later, it costs the host no wait."""

    __slots__ = ("_buf", "_leaves", "_treedef", "_result")

    def __init__(self, buf, leaves, treedef):
        self._buf = buf
        self._leaves = leaves
        self._treedef = treedef
        self._result = None

    def get(self):
        if self._result is None:
            self._result = _unpack(np.asarray(self._buf), self._leaves, self._treedef)
            self._buf = None
        return self._result


def device_fetch_async(tree) -> AsyncFetch:
    """Start a one-buffer async fetch of `tree`; harvest with .get()."""
    buf, leaves, treedef = _pack(tree)
    buf.copy_to_host_async()
    return AsyncFetch(buf, leaves, treedef)
