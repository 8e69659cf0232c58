"""Integer gradient compression collectives over torch.distributed.

Port of `repro.runtime.compress`.  The paper's CQ already puts weight
gradients on a 15-bit grid with a shared power-of-two scale, so the
gradient wire format can be an integer QTensor (int16 halves fp32
traffic, int8 quarters it) with no information lost beyond what WAGEUBN's
own optimizer quantization discards.  The ring reduce-scatter is written
out hop by hop, so every message a rank sends is the integer payload
itself: a library all-reduce would keep the accumulator's dtype on the
wire.

Where the reference runs inside a shard_map over a named mesh axis, the
port runs in every rank of a process group: `group` is the
`torch.distributed` group (None: the default group, or no group at all
when the world is one process, where every collective is the identity)
and `n` its size.  Each ring hop goes point to point
(`dist.batch_isend_irecv`, every send of a hop posted before any received
message is added); the closing gather moves int32 only.  gloo carries
int8, int16 and int32 tensors point to point but refuses int16 in its
collectives, and its point-to-point transfers take host tensors, so on a
gloo group every message is staged through host memory; an nccl group
keeps them on the device.

The wire format IS a QTensor: `wire_quantize` decomposes the local chunks
once into (int payload, shared pow2 scale) and the ring ships the payload.

Overflow control: with n contributions, partial sums of b-bit operands
need b + ceil(log2 n) bits; `wire_quantize` pre-shifts the grid by
`shift` and clips payloads to `wire_limit(bits, shift)` = 2^(bits-1-shift)
- 1, so any partial sum of up to 2^shift payloads stays strictly inside
the signed wire width.  `wire_plan` stages narrow wires at large fan-in
onto int16 hops (the payload keeps its resolution, only the hop widens);
it raises only when even int16 cannot carry the fan-in (shift > 14).

Two layers of API:

  outer wrappers (`compressed_psum_int`, `ring_reduce_scatter_int`) take
  the full local tensor and a group: drop-in collectives.

  step primitives (`ring_allreduce_int`, `wire_sync_mean`,
  `wire_sync_tree`) are what the sharded training step (launch/train.py)
  calls on its per-rank values.  `wire_sync_mean` is the per-leaf
  DP-invariant gradient sync: payload rounding happens per VIRTUAL shard
  against a globally max-reduced pow2 scale with a shift derived from the
  static shard count, and every cross-rank reduction is an exact integer
  sum, so the result is bitwise independent of how the virtual shards are
  laid out over ranks.  `wire_sync_tree` is the same algorithm with one
  stacked max for all leaves, the payload round/clip fused into the local
  pre-sum, and one double-buffered ring over the concatenated pre-sums
  whose int8 hops pack two-per-int16: bitwise equal outputs, a fraction
  of the messages.

`TRACE`: set it to a list and every message this rank sends is appended
as (what, dtype, shape): "hop" (a ring hop), "gather" (the closing int32
gather), "amax" (the scale's max), and the step's "loss", "psum" and
"param" collectives (launch/train.py).  Tests and the card's smoke run
read it; None (the default) records nothing.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import qfuncs as qf
from repro_torch.core.qtensor import QTensor, payload_dtype
from repro_torch.optim import flatten, unflatten

Tensor = torch.Tensor

TRACE: list | None = None


# --------------------------------------------------------------------------
# the grid: shift, limit, plan
# --------------------------------------------------------------------------


def wire_shift(n: int) -> int:
    """Grid pre-shift covering n-way partial sums: ceil(log2 n)."""
    return max(0, math.ceil(math.log2(max(n, 1))))


def wire_limit(bits: int, shift: int) -> float:
    """Largest payload magnitude such that any partial sum of up to 2^shift
    payloads stays strictly inside the signed `bits`-wide wire dtype.

    Raises when the wire is too narrow to carry ANY signal at that fan-in
    (shift > bits - 2, e.g. 256-way sums on an int8 wire): silently clipping
    every payload to zero would be a correctness bug dressed as compression.
    """
    if shift > bits - 2:
        raise ValueError(
            f"{bits}-bit wire cannot carry {2 ** shift}-way partial sums "
            f"(need shift <= bits - 2 = {bits - 2}, got {shift}); "
            f"wire_plan() stages such fan-ins onto int16 hops instead")
    return 2.0 ** (bits - 1 - shift) - 1.0


def wire_plan(bits: int, shift: int) -> tuple[int, int]:
    """Resolve how `bits`-bit payloads survive a 2^shift-way fan-in.

    Returns (clip_shift, hop_bits):

      classic   - shift <= bits - 2: the grid pre-shift is absorbed by the
        payload clip (`wire_limit(bits, shift)`) and partial sums ride hops
        of the payload width itself (hop_bits == bits).
      staged widening - narrow wires at large fan-in (e.g. 4-bit payloads
        summed 8-way) would otherwise clip every payload to zero.  Instead
        the payload keeps full `bits`-bit resolution minus only what int16
        cannot absorb (clip_shift = max(0, shift + bits - 16)) and the
        partial sums ride int16 hops: |payload| <= 2^(bits-1-clip_shift)-1,
        so any sum of up to 2^shift payloads is < 2^15, exact on an int16
        hop.

    Raises only when int16 hops cannot carry the fan-in either
    (clip_shift > bits - 2, i.e. shift > 14).
    """
    if shift <= bits - 2:
        return shift, bits
    clip_shift = max(0, shift + bits - 16)
    if clip_shift > bits - 2:
        raise ValueError(
            f"{bits}-bit payloads cannot survive {2 ** shift}-way partial "
            f"sums even on an int16 hop (needs shift <= 14, got {shift})")
    return clip_shift, 16


def _clip_limit_f32(bits: int, shift: int) -> np.float32:
    """wire_limit as an fp32 clip bound that never exceeds the true bound.

    The clip runs in fp32, where wide limits (bits=32) are not exactly
    representable: 2^30 - 1 would round UP to 2^30 and let payloads escape
    the partial-sum bound, so the bound is lowered to the nearest fp32 at
    or below it (identical for bits <= 24).
    """
    lim = wire_limit(bits, shift)
    limf = np.float32(lim)
    if float(limf) > lim:                  # fp32 rounded up: step back one ulp
        limf = np.nextafter(limf, np.float32(0.0), dtype=np.float32)
    return limf


def _grid(g: Tensor, amax: Tensor, bits: int, shift: int):
    """Rounded, clipped payload values (fp32) and the pow2 wire scale."""
    clip_shift, _ = wire_plan(bits, shift)
    limf = float(_clip_limit_f32(bits, clip_shift))
    scale = qf.pow2_ceil(amax) * 2.0 ** (1 - bits + clip_shift)
    return torch.clamp(torch.round(g / scale), -limf, limf), scale


def wire_quantize(chunks: Tensor, amax: Tensor, bits: int,
                  shift: int) -> QTensor:
    """Decompose gradient chunks into the integer wire QTensor.

    scale = pow2_ceil(amax) * 2^(1 - bits + clip_shift): the effective
    pre-shift (`wire_plan`: the full `shift` on the classic path, the
    int16-staged remainder otherwise) keeps n-way partial sums inside the
    HOP width.  `amax` must already be the global max across participating
    shards (max-reduced by the caller)."""
    vals, scale = _grid(chunks, amax, bits, shift)
    return QTensor(vals.to(payload_dtype(bits)), scale, bits)


def wire_presum(g: Tensor, amax: Tensor, bits: int, shift: int):
    """Payload round/clip and the local pre-sum over axis 0.

    Same grid and clip as `wire_quantize` over g: (vs_local, *shape); the
    per-shard integer payloads are summed in int32, which is exact (the
    sum of up to 2^shift payloads stays below 2^(hop_bits-1), wire_plan's
    invariant).  Returns (int32 pre-sum of shape g.shape[1:], pow2 wire
    scale)."""
    vals, scale = _grid(g, amax, bits, shift)
    return vals.to(torch.int32).sum(0, dtype=torch.int32), scale


def pack_int8_pairs(x: Tensor) -> Tensor:
    """Pack consecutive int8 pairs two-per-int16 (the wire-bits=8 codec).

    x: (..., 2m) int8 -> (..., m) int16 with element i carrying
    (x[2i] in the low byte, x[2i+1] in the high byte).  The low byte rides
    as its two's-complement bit pattern (uint8 view), so every value
    including -128 round-trips exactly through `unpack_int16_pairs`.
    """
    lo = x[..., 0::2].view(torch.uint8).to(torch.int16)
    hi = x[..., 1::2].to(torch.int16) << 8
    return hi | lo


def unpack_int16_pairs(p: Tensor) -> Tensor:
    """Inverse of `pack_int8_pairs`: (..., m) int16 -> (..., 2m) int8.

    The low byte recovers through the uint8 view (-128 included); the high
    byte through an arithmetic shift."""
    lo = (p & 0xFF).to(torch.uint8).view(torch.int8)
    hi = (p >> 8).to(torch.int8)
    return torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1], -1)


# --------------------------------------------------------------------------
# transport: the only place that talks to torch.distributed
# --------------------------------------------------------------------------


def group_size(group=None) -> int:
    """Ranks in `group`; 1 when no process group is initialized."""
    import torch.distributed as dist
    return dist.get_world_size(group) if dist.is_initialized() else 1


def group_rank(group=None) -> int:
    import torch.distributed as dist
    return dist.get_rank(group) if dist.is_initialized() else 0


def _on_host(group) -> bool:
    import torch.distributed as dist
    return dist.get_backend(group) != "nccl"


def _record(what: str, t: Tensor) -> None:
    if TRACE is not None:
        TRACE.append((what, t.dtype, tuple(t.shape)))


def _peer(group, r: int) -> int:
    import torch.distributed as dist
    if group is None or group is dist.group.WORLD:
        return r
    return dist.get_global_rank(group, r)


def ring_exchange(msgs: list, group=None) -> list:
    """One ring hop: send every tensor of `msgs` to rank (r+1)%n and
    receive one of the same shape and dtype from (r-1)%n each.  All sends
    and receives of the hop are posted before any is waited on."""
    import torch.distributed as dist
    n, r = group_size(group), group_rank(group)
    dst, src = _peer(group, (r + 1) % n), _peer(group, (r - 1) % n)
    host = _on_host(group)
    out = [m.contiguous().cpu() if host else m.contiguous() for m in msgs]
    bufs = [torch.empty_like(m) for m in out]
    ops = []
    for b, (m, buf) in enumerate(zip(out, bufs)):
        _record("hop", m)
        ops.append(dist.P2POp(dist.isend, m, dst, group, tag=b))
        ops.append(dist.P2POp(dist.irecv, buf, src, group, tag=b))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [buf.to(m.device) for buf, m in zip(bufs, msgs)]


def all_gather(x: Tensor, group=None, what: str = "gather") -> Tensor:
    """(n, *x.shape): every rank's `x` in rank order."""
    import torch.distributed as dist
    if group_size(group) == 1:
        return x[None]
    _record(what, x)
    host = _on_host(group)
    src = x.contiguous().cpu() if host else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(group_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(x.device)


def all_reduce(x: Tensor, op: str, group=None, what: str = "amax") -> Tensor:
    """A new tensor: `x` reduced over the group by op "max" or "sum"."""
    import torch.distributed as dist
    if group_size(group) == 1:
        return x.clone()
    _record(what, x)
    host = _on_host(group)
    t = x.detach().clone().cpu() if host else x.detach().clone()
    dist.all_reduce(t, op={"max": dist.ReduceOp.MAX,
                           "sum": dist.ReduceOp.SUM}[op], group=group)
    return t.to(x.device)


# --------------------------------------------------------------------------
# outer wrappers
# --------------------------------------------------------------------------


def _ring_reduce_scatter(qt: QTensor, group, n: int,
                         hop_bits: int | None = None) -> Tensor:
    """qt.data: (n, chunk) integer contributions of this rank.

    Classic ring: rank r starts with its contribution to chunk (r-1)%n and
    after n-1 hops holds the fully reduced chunk r.  Every message on the
    wire is the `hop_bits` integer dtype (default: the payload width;
    staged widening passes 16 to carry sub-8 payload sums), never fp32."""
    x_int = qt.data
    hop_bits = qt.k if hop_bits is None else hop_bits
    # clip in the int32 domain: float bounds near 2^31 are not exactly
    # representable in fp32
    lim = min(2 ** (hop_bits - 1) - 1, 2 ** 31 - 1)
    dtype = payload_dtype(hop_bits)
    r = group_rank(group)
    acc = x_int[(r - 1) % n].to(torch.int32)
    for i in range(n - 1):
        msg, = ring_exchange([torch.clamp(acc, -lim, lim).to(dtype)], group)
        acc = msg.to(torch.int32) + x_int[(r - 2 - i) % n]
    return acc


def _chunks(x: Tensor, n: int):
    flat = x.reshape(-1)
    pad = -flat.numel() % n
    return F.pad(flat, (0, pad)).reshape(n, -1), pad


def ring_reduce_scatter_int(x: Tensor, group=None, bits: int = 16) -> Tensor:
    """Reduce-scatter x (the same shape on every rank) over the group,
    quantizing every wire message to the `bits`-wide integer payload.
    Returns this rank's shard of the mean, fp32."""
    n = group_size(group)
    shift = wire_shift(n)
    _, hop_bits = wire_plan(bits, shift)
    chunks, _ = _chunks(x, n)
    amax = all_reduce(chunks.abs().max(), "max", group)
    qt = wire_quantize(chunks, amax, bits, shift)
    acc = _ring_reduce_scatter(qt, group, n, hop_bits)
    return acc.to(torch.float32) * qt.scale / n


def compressed_psum_int(x: Tensor, group=None, bits: int = 16) -> Tensor:
    """Integer-wire all-reduce mean = ring reduce-scatter + all-gather."""
    n = group_size(group)
    shift = wire_shift(n)
    _, hop_bits = wire_plan(bits, shift)
    chunks, pad = _chunks(x, n)
    amax = all_reduce(chunks.abs().max(), "max", group)
    qt = wire_quantize(chunks, amax, bits, shift)
    acc = _ring_reduce_scatter(qt, group, n, hop_bits)
    # rank i holds chunk i, so rank order IS chunk order
    full = all_gather(acc, group).reshape(-1)
    full = full[: full.numel() - pad] if pad else full
    return (full.to(torch.float32) * qt.scale / n).reshape(x.shape)


# --------------------------------------------------------------------------
# step primitives
# --------------------------------------------------------------------------


def ring_allreduce_int(x: Tensor, group, n: int, bits: int, *,
                       pack: bool = False, buckets: int = 1) -> Tensor:
    """Exact integer all-reduce-sum of per-rank int32 contributions.

    Ring reduce-scatter (messages in the `bits`-wide wire dtype) followed
    by an int32 all-gather.  The caller guarantees every partial sum fits
    the wire width (the contract `wire_quantize` establishes via its
    shift/clip), so the per-hop cast never wraps and the sum is exact.
    `n` is the group's size and `bits` the HOP width: the payload width on
    the classic path, 16 when `wire_plan` staged a narrower payload onto
    int16 hops.

    pack (int8 hops, bits <= 8): consecutive int8 payload pairs ride
    two-per-int16, halving each hop's element count; pack/unpack is a
    lossless bit-pattern transform.  buckets=2 double-buffers the ring:
    each chunk splits in two and BOTH buckets' sends are posted before
    either received message is added.  Bucket order is restored before
    the all-gather, so the reduced values are the same for any bucket
    count.
    """
    assert not (pack and bits > 8), "pair packing needs int8-dtype hops"
    dtype = payload_dtype(bits)
    flat = x.reshape(-1)
    unit = n * buckets * (2 if pack else 1)
    pad = -flat.numel() % unit
    chunks = F.pad(flat, (0, pad)).reshape(n, buckets, -1)
    r = group_rank(group)
    accs = list(chunks[(r - 1) % n].to(torch.int32))

    def to_wire(a):
        a = a.to(dtype)
        return pack_int8_pairs(a) if pack else a

    def from_wire(m):
        return (unpack_int16_pairs(m) if pack else m).to(torch.int32)

    for i in range(n - 1):
        msgs = ring_exchange([to_wire(a) for a in accs], group)
        nxt = chunks[(r - 2 - i) % n]
        accs = [from_wire(m) + nxt[b] for b, m in enumerate(msgs)]
    acc = torch.cat([a.reshape(-1) for a in accs])
    full = all_gather(acc, group).reshape(-1)
    full = full[: full.numel() - pad] if pad else full
    return full.reshape(x.shape)


def wire_sync_mean(g: Tensor, group=None, *, n_shards: int, n_dev: int,
                   bits: int = 16) -> Tensor:
    """DP-invariant integer-wire mean of per-virtual-shard contributions.

    g: (vs_local, *shape) fp32, this rank's virtual-shard gradients.
    Returns (*shape,) fp32: the mean over all `n_shards` virtual shards
    across the group (size `n_dev`).

    Bit-exactness contract: the ONE cross-rank scale reduction is the max
    of the shard-local amax; payload rounding happens per VIRTUAL shard
    against that shared pow2 scale with shift = ceil(log2 n_shards) (a
    static property of the algorithm, not of the layout), and both the
    local pre-sum and the ring are exact integer additions.  Every
    quantity is therefore a pure function of (n_shards, global batch).
    """
    shift = wire_shift(n_shards)
    _, hop_bits = wire_plan(bits, shift)
    amax = all_reduce(g.abs().max(), "max", group)
    qt = wire_quantize(g, amax, bits, shift)
    local = qt.data.to(torch.int32).sum(0, dtype=torch.int32)
    total = ring_allreduce_int(local, group, n_dev, hop_bits)
    return total.to(torch.float32) * qt.scale / n_shards


def wire_sync_tree(grads, group=None, *, n_shards: int, n_dev: int,
                   bits: int = 16):
    """Whole-tree integer-wire gradient sync: the packed wire codec.

    Value-identical to mapping `wire_sync_mean` over the tree (same amax,
    same grid, same exact integer sums), shaped for fewer messages:

      * ONE stacked max: every leaf's local amax reduces in a single
        (n_leaves,) collective (the max is elementwise, so each lane equals
        its scalar run).
      * fused pre-sum (`wire_presum`).
      * ONE ring: the int32 pre-sums concatenate into a flat buffer that
        rides a single double-buffered ring and gather, 2 (n_dev - 1) hop
        messages a step instead of n_dev - 1 per leaf.  At wire-bits 8 the
        hops pack two-per-int16 (`pack_int8_pairs`).

    grads: tree (nested dicts and lists, or a list) of (vs_local, *shape)
    fp32.  Returns the matching tree of (*shape,) fp32 means over all
    `n_shards` virtual shards.
    """
    leaves = flatten(grads)
    if not leaves:
        return grads
    shift = wire_shift(n_shards)
    _, hop_bits = wire_plan(bits, shift)
    amax = all_reduce(torch.stack([g.abs().max() for g in leaves]), "max",
                      group)
    presums, scales = [], []
    for i, g in enumerate(leaves):
        ps, scale = wire_presum(g, amax[i], bits, shift)
        presums.append(ps.reshape(-1))
        scales.append(scale)
    flat = torch.cat(presums) if len(presums) > 1 else presums[0]
    total = ring_allreduce_int(flat, group, n_dev, hop_bits,
                               pack=hop_bits <= 8,
                               buckets=2 if n_dev > 1 else 1)
    outs, off = [], 0
    for g, scale in zip(leaves, scales):
        shape = g.shape[1:]
        size = math.prod(shape)
        seg = total[off:off + size]
        # the same float expression as wire_sync_mean: bitwise-equal means
        outs.append((seg.to(torch.float32) * scale / n_shards).reshape(shape))
        off += size
    return unflatten(grads, outs)


def default_wire_codec(backend: str | None = None,
                       group=None) -> tuple[str, str]:
    """`--wire-codec auto` by the group's backend.  Returns (codec, why).

    The packed whole-tree codec halves the on-wire elements at 8 bits and
    sends 2 hop messages a step; on nccl, where a message stays on the
    device, it is the codec.  On gloo every message is staged through
    host memory and sent over sockets; there the port keeps the
    reference's CPU choice, the per-leaf rings.  Both codecs are bitwise
    equal, so the choice never moves a number."""
    if backend is None:
        import torch.distributed as dist
        backend = (dist.get_backend(group) if dist.is_initialized()
                   else "gloo")
    if backend == "nccl":
        return "packed", "nccl: 2x fewer on-wire elements, 2 hops/step"
    return "leaf", (f"{backend}: host-staged socket transfers; per-leaf "
                    "rings, as the reference picks on its CPU backend")
