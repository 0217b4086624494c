"""Element-sharded (sequence-parallel) Fast-SSC DECODE for huge N.

Closes SURVEY.md §5's stretch goal for the decoder side (VERDICT r1
next-round #2): the top tree levels' f/g/combine math
(``polar_decoder.hh:28-59``) runs under ``jax.shard_map``
with the codeword **element axis** sharded over the mesh, exchanging the
partner half-shards with one ``ppermute`` per op; below the
per-device shard size the recursion hands off to the existing trace-time
local tree decoder (:class:`polar_tpu.decode.fastssc._TreeDecoder`).

SPMD representation. A tree node of size ``L = n_sh * S`` (``S`` = per-
device shard size) occupies the contiguous shard range ``[base, base +
n_sh)``; its distributed value is carried as a per-device ``(B, S)``
block that is *valid on the owning range and don't-care elsewhere* —
every device executes the same program (shard_map traces once), role
masks select results. Child values follow the soft-pyramid convention of
the reference decoder: they live on the FIRST half of the parent's range.

At ``n_sh == 1`` the subtree's input sits wholly on one known shard.
Each such subtree is a **distinct trace-time call site**, so its
frozen-pattern-specialized local decoder is part of the single SPMD
program; the input is all-gathered and decoded redundantly on every
device (the sequential nature of SC decoding means the other shards
would otherwise idle — redundant decode costs no wall-clock and keeps
the program uniform).

Message output: the decoder returns the **u-domain leaf estimate**
``(B, N)``, element-sharded exactly like the input LLRs (frozen slots
hold +1, the reference's frozen convention); gather ``[..., info]``
for the (B, K) message. This keeps the output layout local to each
shard — no cross-device message compaction.

Semantics are op-for-op those of the local decoder (same arith objects),
so int8 decodes remain bit-exact with the reference
(tests/test_seqpar_decode.py checks against the local path at m >= 12 on
the 8-device CPU mesh).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..code.compiler import Node, compile_code
from ..code.construction import PolarCode
from ..decode.fastssc import _TreeDecoder, _resolve_arith
from ..ops.transform import polar_transform
from .seqpar import SEQ_AXIS


class _ShardedTreeDecoder:
    """Trace-time recursion emitting the SPMD sharded decode program.

    ``d``: traced device index along the element axis; ``n_dev`` total
    shards; ``axis`` the mesh axis name. All ``base``/``n_sh`` values are
    Python ints (trace-time), so masks and permutations are static.
    """

    def __init__(self, ph, axis: str, n_dev: int, shard: int,
                 batch_split: bool = False):
        self.ph = ph
        self.axis = axis
        self.n_dev = n_dev
        self.shard = shard  # S: elements per device
        self.batch_split = batch_split
        self.d = jax.lax.axis_index(axis)

    # -- communication helpers -----------------------------------------
    def _pull_from(self, x, offset: int):
        """Every device receives x from the device ``offset`` positions
        ahead (d + offset, wrapping; wrapped lanes are masked by role)."""
        perm = [(s, (s - offset) % self.n_dev) for s in range(self.n_dev)]
        return jax.lax.ppermute(x, self.axis, perm)

    def _push_right(self, x, offset: int):
        """Every device receives x from ``offset`` positions behind."""
        perm = [(s, (s + offset) % self.n_dev) for s in range(self.n_dev)]
        return jax.lax.ppermute(x, self.axis, perm)

    def _bcast_from(self, x, src: int):
        """Replicate shard ``src``'s (B, 1) scalar-per-frame to all
        devices (ppermute cannot fan out one->many; the payload is tiny)."""
        return jax.lax.all_gather(x, self.axis)[src]

    def _is_in(self, base: int, n_sh: int):
        return (self.d >= base) & (self.d < base + n_sh)

    def _left_then_push(self, soft, n2: int, decode_left):
        """Decode the left child and push ``(soft, hard_l)`` right by
        ``n2``; returns ``(hard_l, u_l, soft_pushed, hard_pushed)``.

        The ``soft`` push has no data dependency on the left decode, so
        it is issued as its OWN collective *before* the recursion — XLA's
        async collective scheduler can then overlap the transfer with the
        left subtree's compute."""
        soft_p = self._push_right(soft, n2)
        hard_l, u_l = decode_left()
        return hard_l, u_l, soft_p, self._push_right(hard_l, n2)

    # -- distributed polar transform over a shard range ------------------
    def _transform(self, x, base: int, n_sh: int):
        """Value-domain polar transform of the node's hard estimate,
        distributed over ``[base, base+n_sh)`` — local stages first, then
        one ppermute per cross-shard stage (the decode-side twin of
        :func:`polar_tpu.parallel.seqpar._sharded_transform_local`)."""
        x = polar_transform(x)
        d_rel = self.d - base
        m = 1
        while m < n_sh:
            partner = self._pull_from(x, m)
            is_lower = (d_rel // m) % 2 == 0
            x = jnp.where(is_lower, self.ph.qmul(x, partner), x)
            m *= 2
        return x

    # -- sharded node kinds ---------------------------------------------
    def decode(self, node: Node, soft, base: int, n_sh: int):
        """Returns ``(hard, u)``: the node's codeword estimate and
        u-domain leaf estimate, both distributed over the node's range."""
        if n_sh == 1:
            return self._local_subtree(node, soft, base)
        ph = self.ph
        kind = node.kind
        n2 = n_sh // 2
        ones = jnp.ones_like(soft)
        if kind == "rate0":
            return ones, ones
        if kind == "rate1":
            hard = ph.signum(soft)
            return hard, self._transform(hard, base, n_sh)
        if kind == "rep":
            acc, m = soft, n_sh
            while m > 1:
                acc = ph.qadd(acc, self._pull_from(acc, m // 2))
                m //= 2
            local = acc  # valid on shard `base`
            while local.shape[-1] > 1:
                half = local.shape[-1] // 2
                local = ph.qadd(local[..., :half], local[..., half:])
            bit = self._bcast_from(ph.signum(local), base)
            hard = jnp.broadcast_to(bit, soft.shape)
            u_last = ones.at[..., -1].set(bit[..., 0])
            u = jnp.where(self.d == base + n_sh - 1, u_last, ones)
            return hard, u
        if kind == "spc":
            hard = ph.decide(soft)
            sabs = ph.qabs(soft)
            par = jnp.prod(hard, axis=-1, keepdims=True).astype(hard.dtype)
            weak = jnp.min(sabs, axis=-1, keepdims=True)
            m = n_sh
            while m > 1:
                # one stacked exchange per stage (ppermute of a stack ==
                # stacked ppermutes, one collective instead of two)
                both = self._pull_from(jnp.stack([par, weak]), m // 2)
                par = ph.qmul(par, both[0])
                weak = ph.qmin(weak, both[1])
                m //= 2
            par = self._bcast_from(par, base)
            weak = self._bcast_from(weak, base)
            hard = ph.flip(hard, par, weak, sabs)
            trans = self._transform(hard, base, n_sh)
            u_first = trans.at[..., 0].set(jnp.ones_like(trans[..., 0]))
            u = jnp.where(self.d == base, u_first, trans)
            return hard, u
        if kind == "rate0_right":
            # g with implicit all-(+1) left half: saturating add
            child = ph.qadd(soft, self._pull_from(soft, n2))
            hard_r, u_r = self.decode(node.right, child, base, n2)
            # stacked push: one collective for both tracks
            pushed = self._push_right(jnp.stack([hard_r, u_r]), n2)
            hard = jnp.where(self._is_in(base, n2), hard_r, pushed[0])
            u = jnp.where(self._is_in(base, n2), ones, pushed[1])
            return hard, u
        if kind == "rate1_comb":
            upper = self._pull_from(soft, n2)
            child = ph.prod(soft, upper)
            hard_l, u_l, soft_p, hard_p = self._left_then_push(
                soft, n2, lambda: self.decode(node.left, child, base, n2))
            hard_r = ph.signum(ph.madd(hard_p, soft_p, soft))
            trans_r = self._transform(hard_r, base + n2, n2)
            is_left = self._is_in(base, n2)
            hard = jnp.where(is_left,
                             ph.qmul(hard_l, self._pull_from(hard_r, n2)),
                             hard_r)
            return hard, jnp.where(is_left, u_l, trans_r)
        if kind == "branch":
            upper = self._pull_from(soft, n2)
            child = ph.prod(soft, upper)
            hard_l, u_l, soft_p, hard_p = self._left_then_push(
                soft, n2, lambda: self.decode(node.left, child, base, n2))
            child_r = ph.madd(hard_p, soft_p, soft)
            hard_r, u_r = self.decode(node.right, child_r, base + n2, n2)
            is_left = self._is_in(base, n2)
            hard = jnp.where(is_left,
                             ph.qmul(hard_l, self._pull_from(hard_r, n2)),
                             hard_r)
            return hard, jnp.where(is_left, u_l, u_r)
        raise AssertionError(kind)  # pragma: no cover

    def _local_subtree(self, node: Node, soft, base: int):
        """Shard-size node: decode the whole subtree with the local
        trace-time decoder (this call site is specialized to THIS
        subtree's frozen pattern — uniform across devices because the
        specialization happens per call site, not per device).

        Default mode decodes the subtree redundantly on every device (SC
        is sequential across subtrees — the other shards would idle
        anyway). ``batch_split`` mode instead splits the FRAME batch over
        the mesh for the subtree decode and re-gathers the results: total
        decode work drops D-fold, at the price of one extra all_gather —
        the work-efficient choice when B is large."""
        inp = jax.lax.all_gather(soft, self.axis)[base]
        dec = _TreeDecoder(self.ph)
        if self.batch_split and inp.shape[0] % self.n_dev == 0:
            nb = inp.shape[0] // self.n_dev
            mine = jax.lax.dynamic_slice_in_dim(inp, self.d * nb, nb, axis=0)
            hard_mine = dec.decode(node, mine)
            gathered = jax.lax.all_gather(hard_mine, self.axis)  # (D, nb, S)
            hard = gathered.reshape(inp.shape)
        else:
            hard = dec.decode(node, inp)
        u = jnp.ones_like(hard)
        if dec.mesg:
            mesg = jnp.concatenate(dec.mesg, axis=-1)
            info = np.flatnonzero(_leaf_frozen(node) == 0)
            if self.batch_split and inp.shape[0] % self.n_dev == 0:
                u_mine = jnp.ones_like(mine).at[..., info].set(mesg)
                u = jax.lax.all_gather(u_mine, self.axis).reshape(u.shape)
            else:
                u = u.at[..., info].set(mesg)
        return hard, u


def _leaf_frozen(node: Node) -> np.ndarray:
    """Reconstruct the subtree's frozen mask from its node kinds."""
    n = 1 << node.level
    if node.kind == "rate0":
        return np.ones(n, np.uint8)
    if node.kind == "rate1":
        return np.zeros(n, np.uint8)
    if node.kind == "rep":
        m = np.ones(n, np.uint8)
        m[-1] = 0
        return m
    if node.kind == "spc":
        m = np.zeros(n, np.uint8)
        m[0] = 1
        return m
    if node.kind == "rate0_right":
        return np.concatenate([np.ones(n // 2, np.uint8),
                               _leaf_frozen(node.right)])
    if node.kind == "rate1_comb":
        return np.concatenate([_leaf_frozen(node.left),
                               np.zeros(n // 2, np.uint8)])
    return np.concatenate([_leaf_frozen(node.left), _leaf_frozen(node.right)])


def make_seqpar_decoder(
    code: PolarCode,
    mesh: Mesh,
    axis: str = SEQ_AXIS,
    *,
    tree: Node | None = None,
    compute=None,
    output: str = "u_full",
    batch_split: bool = False,
):
    """Element-sharded Fast-SSC decoder: LLRs ``(B, N)`` sharded on the
    element axis over ``mesh[axis]`` → u-domain estimate ``(B, N)`` with
    the same sharding (``output="u_full"``; frozen slots +1), or the
    gathered ``(B, K)`` message (``output="u"``).

    ``compute`` follows :func:`polar_tpu.decode.fastssc.make_fastssc_decoder`
    (None = infer from dtype; int8 semantics are bit-exact with the
    reference and the local decoders).

    ``batch_split``: split the frame batch across the mesh for each
    shard-size subtree decode (work-efficient; needs B divisible by the
    shard count) instead of decoding subtrees redundantly on every
    device. Identical results either way.
    """
    if tree is None:
        tree = compile_code(code)
    n_dev = mesh.shape[axis]
    if code.N % n_dev or (n_dev & (n_dev - 1)):
        raise ValueError(f"N={code.N} needs a power-of-two shard count, "
                         f"got {n_dev}")
    shard = code.N // n_dev
    if shard < 4:
        raise ValueError(f"shard size {shard} < 4 (use fewer devices)")
    if output not in ("u_full", "u"):
        raise ValueError(f"unknown output mode {output!r}")
    info = code.info_indices

    def decode(llrs):
        ph, work_dtype = _resolve_arith(compute, llrs.dtype)
        x = llrs if work_dtype is None else llrs.astype(work_dtype)

        def body(x_loc):
            dec = _ShardedTreeDecoder(ph, axis, n_dev, shard,
                                      batch_split=batch_split)
            _, u = dec.decode(tree, x_loc, 0, n_dev)
            return u

        spec = P(*([None] * (x.ndim - 1) + [axis]))
        u_full = jax.shard_map(body, mesh=mesh, in_specs=spec,
                               out_specs=spec)(x)
        if output == "u":
            return u_full[..., info]
        return u_full

    return decode
