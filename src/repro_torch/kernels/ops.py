"""The port's ops: a Hopper kernel for a CUDA tensor, the plain PyTorch
version (`kernels/ref.py`) for a CPU tensor.

  qmatmul          K1  int8 x int8 -> int32 MAC (batched), optional fused
                       requantize epilogue emitting an int8 payload
  quantize         K2  payload emission clip(rint(x * inv_step), +-lim)
  dgrad, wgrad     K3  Alg. 2 backward dots with Q_E2 fused in the prologue
  ubn_norm         K4  fused UBN: statistics + normalize + quantizers
                       (per row for "rms"/"layer", per column for "batch")
  cq_stochastic    K8  stochastic CQ payload from given random bits
  flash_attention  K5  tiled online-softmax int8 attention (training fwd)
  page_gather      K7  paged int8 KV gather through a page table
  paged_attention  K6  paged int8 decode attention over the live positions
  selective_scan   K9  the Mamba1 recurrence with a carried state, on
                       fp32 or bf16 carriers; its gradient is an autograd
                       Function whose backward is
  selective_scan_bwd K9b the reverse scan (port-only: the reference
                       differentiates an XLA scan)

Routing is by the tensor's device alone.  On a CUDA tensor an op launches
its kernel or raises: no shape guard sends it elsewhere and nothing falls
back.  The one way to run the plain versions on the card is to ask for it,
`with plain_reference():` (chip_smoke.py holds the kernels against them
that way); the serving path never enters it.

`LAUNCHES` counts kernel launches per op: an op adds one each time it
launches its kernel (K6 counts one per call, which is three launches
with nothing between them; K1, K3, K4 "batch", K5 and K7 count
one per call likewise, and K9b one per call for its scan and its dc
pass) and never on the plain route.  A training step with remat "full"
(models/layers.py `maybe_remat`) runs each layer's forward again in the
backward, and those launches count too.
"""
from __future__ import annotations

import contextlib
import math
from ctypes import POINTER, c_float, c_int, c_longlong, c_void_p

import torch

from . import _build, ref

Tensor = torch.Tensor

LAUNCHES = {"qmatmul": 0, "quantize": 0, "ubn_norm": 0, "page_gather": 0,
            "paged_attention": 0, "dgrad": 0, "wgrad": 0,
            "flash_attention": 0, "cq_stochastic": 0, "selective_scan": 0,
            "selective_scan_bwd": 0}

_PLAIN = False

# launch function -> argument types (pointers and the stream as c_void_p)
_P = c_void_p
_SIGS = {
    ("quantize", "quantize_launch"): [_P, _P, c_float, _P, c_longlong, _P],
    ("quantize", "cq_launch"): [_P, _P, _P, c_float, _P, c_longlong, _P],
    ("qmatmul", "qmatmul_launch"): [_P, _P, _P, _P, _P, c_float,
                                    POINTER(c_longlong), c_int, c_int, c_int,
                                    c_int, c_int, c_int, _P, _P, _P, _P],
    ("ubn", "ubn_launch"): [_P, _P, _P, _P] + [c_int] * 5 + [c_float] * 6
    + [_P],
    ("ubn", "fp32_check_launch"): [c_longlong, _P, c_int, _P, _P],
    ("ubn", "ubn_batch_launch"): [_P] * 6 + [c_longlong] + [c_int] * 5
    + [c_longlong, c_int, c_longlong] + [c_float] * 6 + [_P],
    ("page_gather", "page_gather_launch"): [_P] * 5 + [c_int] * 6 + [
        c_longlong, c_int, _P],
    ("paged_attention", "pa_launch"): [_P] * 6 + [c_int] + [_P] * 3
    + [c_float] * 3 + [c_int] * 8
    + [_P] + [c_longlong] * 6 + [_P] * 3,
    ("backward", "bwd_launch"): [_P] * 8 + [c_int, c_int, c_float, c_int,
                                            c_int, c_int, c_int, c_int, _P],
    ("flash_attention", "fa_launch"): [c_int] + [_P] * 16 + [
        c_float, c_float, c_float, c_int, c_int, c_int, c_int, c_int, c_int,
        c_int, c_int, c_int, _P],
    ("flash_attention", "fa_pcode_check"): [_P, _P, _P],
    ("selective_scan", "sscan_launch"): [_P] * 6 + [c_int] * 7 + [_P],
    ("selective_scan", "sscan_bf16_launch"): [_P] * 6 + [c_int] * 7 + [_P],
    ("selective_scan_bwd", "sscan_bwd_launch"): [_P] * 11 + [c_int] * 4
    + [_P],
    ("selective_scan_bwd", "sscan_bwd_bf16_launch"): [_P] * 12
    + [c_int] * 4 + [_P],
}
_FNS: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def plain_reference():
    """Run the plain PyTorch versions on any device inside this context
    (for holding the kernels against them on the card)."""
    with contextlib.ExitStack() as restore:
        restore.callback(_set_plain, _PLAIN)
        _set_plain(True)
        yield


def _set_plain(on: bool) -> None:
    global _PLAIN
    _PLAIN = on


def _on_kernel(t: Tensor) -> bool:
    if t.device.type == "cpu" or _PLAIN:
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {t.device}")
    return True


def _fn(lib: str, name: str):
    key = (lib, name)
    if key not in _FNS:
        f = getattr(_build.library(lib), name)
        f.argtypes = _SIGS[key]
        f.restype = c_int
        _FNS[key] = f
    return _FNS[key]


def _launch(lib: str, name: str, *args) -> None:
    rc = _fn(lib, name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def _ptr(t: Tensor | None):
    return None if t is None else t.data_ptr()


def _stream(t: Tensor):
    """The current stream of t's card as a raw pointer, read without
    building a torch.cuda.Stream object (a host cost that a decode-shape
    launch, bound by host work, would pay on every call)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _need(cond: bool, msg: str, *args) -> None:
    """Raise ValueError(msg.format(*args)) unless cond: the message is
    formatted only on failure (a decode-shape call is bound by host work)."""
    if not cond:
        raise ValueError(msg.format(*args) if args else msg)


def _scalar(v, like: Tensor) -> Tensor:
    """A device fp32 0-d tensor (scales stay on the device: no host sync);
    one that already is so is returned as it is (no host ops)."""
    if isinstance(v, Tensor) and v.dim() == 0 \
            and v.dtype == torch.float32 and v.device == like.device:
        return v
    return torch.as_tensor(v, dtype=torch.float32,
                           device=like.device).reshape(())


def _as(t: Tensor, dtype, like: Tensor) -> Tensor:
    """t contiguous, of `dtype` and on like's device, as it lies where it
    already is so (no host work beyond the checks)."""
    if t.dtype == dtype and t.device == like.device and t.is_contiguous():
        return t
    return t.to(device=like.device, dtype=dtype).contiguous()


# --------------------------------------------------------------------------
# K1 qmatmul
# --------------------------------------------------------------------------

_SMS: dict[int, int] = {}


def _sm_count(dev: torch.device) -> int:
    """The card's SM count, read once per device."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _layout(t: Tensor):
    """(flag, row pitch) of t's last two dimensions as the K1 kernel reads
    them: 0 row-major, element (i, j) at i * ld + j; 1 transposed, at
    j * ld + i.  None when neither dimension is contiguous."""
    r, c = t.shape[-2:]
    sr, sc = t.stride()[-2:]
    if c == 1 or sc == 1:
        return 0, sr if r > 1 else 0
    if r == 1 or sr == 1:
        return 1, sc if c > 1 else 0
    return None


def _batch_dims(a: Tensor, b: Tensor, shape) -> list:
    """The broadcast batch dimensions `shape` of a and b as (size, a
    stride, b stride), 0 where an operand broadcasts, with size-1
    dimensions dropped and neighbours merged where both operands allow."""
    dims: list = []
    for i, n in enumerate(shape):
        if n == 1:
            continue
        st = []
        for t in (a, b):
            j = i - len(shape) + t.dim() - 2
            st.append(t.stride(j) if j >= 0 and t.shape[j] != 1 else 0)
        if dims and dims[-1][1] == st[0] * n and dims[-1][2] == st[1] * n:
            dims[-1] = (dims[-1][0] * n, st[0], st[1])
        else:
            dims.append((n, st[0], st[1]))
    return dims


def _qmm_operands(a8: Tensor, b8: Tensor):
    """What K1 reads: (a, b, batch shape, desc).  a and b are the operands
    as given where their last two dimensions are contiguous either way and
    their broadcast batch dimensions merge into at most three; otherwise a
    contiguous copy.  desc holds each operand's three batch strides, row
    pitch and layout flag, then the sizes n1, n2 of the batch (n0, n1,
    n2)."""
    shape = torch.broadcast_shapes(a8.shape[:-2], b8.shape[:-2])
    a, b = a8, b8
    if _layout(a) is None:
        a = a.contiguous()
    if _layout(b) is None:
        b = b.contiguous()
    dims = _batch_dims(a, b, shape)
    if len(dims) > 3:
        a = a.expand(*shape, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
        b = b.expand(*shape, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
        dims = _batch_dims(a, b, a.shape[:-2])
    dims = [(1, 0, 0)] * (3 - len(dims)) + dims
    (fa, lda), (fb, ldb) = _layout(a), _layout(b)
    desc = [d[1] for d in dims] + [lda, fa] + [d[2] for d in dims] \
        + [ldb, fb, dims[1][0], dims[2][0]]
    return a, b, tuple(shape), desc


def _qmm_splits(z: int, m: int, n: int, k: int, sms: int) -> tuple[int, int]:
    """(splits, depth per split) of K1's contraction.  M > 16 (128 x 128
    tiles, 128-deep k tiles): split only when the tiles cannot fill the
    SMs, up to two blocks an SM.  M <= 16 (128 columns a block, 64-deep
    stages): split until there are about four blocks an SM, each slice at
    least four stages deep."""
    if m > 16:
        kt = -(-k // 128)
        tiles = z * -(-m // 128) * -(-n // 128)
        want = min(kt, (2 * sms) // tiles) if tiles < sms else 1
        step = 128
    else:
        kt = -(-k // 64)
        blocks = z * -(-n // 128)
        want = min(-(-4 * sms // blocks), max(1, kt // 4))
        step = 64
    per = -(-kt // max(want, 1))
    return -(-kt // per), per * step


_QMM_PLANS: dict = {}


def _qmm_plan(a8: Tensor, b8: Tensor):
    """K1's launch for these operands: (a, b, output shape, desc array, z,
    splits, kper, and the scratch's layout: split-partial bytes, A's
    operand-tile bytes, total bytes).  Cached by shapes and strides where
    the operands are read as they lie (a serving step repeats its shapes
    every step)."""
    key = (a8.shape, a8.stride(), b8.shape, b8.stride(), a8.device)
    plan = _QMM_PLANS.get(key)
    if plan is not None:
        return (a8, b8) + plan
    m, k = a8.shape[-2:]
    n = b8.shape[-1]
    a, b, shape, desc = _qmm_operands(a8, b8)
    z = math.prod(shape)
    splits, kper = _qmm_splits(z, m, n, k, _sm_count(a.device)) \
        if z and m and n and k else (1, 0)
    _need(z < 65536 and splits < 65536 and -(-max(m, n) // 128) < 65536,
          "qmatmul: batch or shape too large for one launch")
    # scratch: the split partials (int32), then the operand pass's tiles
    ws = -(-(splits * z * m * n * 4 if splits > 1 else 0) // 256) * 256
    kt = -(-k // 128)
    at = z * -(-m // 128) * kt * 16384 if m > 16 else 0
    bt = z * -(-n // 128) * kt * 16384 if m > 16 else 0
    plan = (shape + (m, n), (c_longlong * 12)(*desc), z, splits, kper, ws,
            at, ws + at + bt)
    if a is a8 and b is b8:
        if len(_QMM_PLANS) >= 4096:
            _QMM_PLANS.clear()
        _QMM_PLANS[key] = plan
    return (a, b) + plan


def qmatmul(a8: Tensor, b8: Tensor, requant_inv=None, *,
            lim: float = 127.0) -> Tensor:
    """int8 (.., M, K) x int8 (.., K, N) -> int32 (.., M, N), batched and
    broadcast like torch.matmul over the leading dimensions.

    With `requant_inv` (scalar: the pow2 rescale a_scale * b_scale /
    out_step) the epilogue emits clip(round(acc * requant_inv), +-lim) as
    int8.  On the card an operand whose last two dimensions are contiguous
    either way (a permuted view, a transpose) is read as it lies; any
    other is copied first."""
    if not _on_kernel(a8):
        inv = None if requant_inv is None else _scalar(requant_inv, a8)
        return ref.qmatmul(a8, b8, inv, lim=lim)
    if not (a8.dtype == torch.int8 and b8.dtype == torch.int8
            and a8.dim() >= 2 and b8.dim() >= 2 and b8.device == a8.device
            and a8.shape[-1] == b8.shape[-2]):
        raise ValueError(f"qmatmul takes int8 (.., M, K) x (.., K, N) on one "
                         f"device, got {tuple(a8.shape)} x {tuple(b8.shape)}")
    a, b, out_shape, desc, z, splits, kper, ws, at, scratch = \
        _qmm_plan(a8, b8)
    dev = a.device
    inv = None if requant_inv is None else _scalar(requant_inv, a)
    out = torch.empty(out_shape, dtype=torch.int32 if inv is None
                      else torch.int8, device=dev)
    if kper == 0:                 # an empty product or an empty output
        return out.zero_()
    base = buf = None
    if scratch:       # kept referenced until the launch is enqueued
        buf = torch.empty(scratch, dtype=torch.uint8, device=dev)
        base = buf.data_ptr()
    m, n, k = out_shape[-2], out_shape[-1], a.shape[-1]
    _launch("qmatmul", "qmatmul_launch", _ptr(a), _ptr(b),
            None if inv is not None else out.data_ptr(),
            None if inv is None else out.data_ptr(), _ptr(inv), lim, desc, z,
            m, n, k, splits, kper, base if ws else None,
            base + ws if at else None, base + ws + at if at else None,
            _stream(a))
    LAUNCHES["qmatmul"] += 1
    return out


# --------------------------------------------------------------------------
# K2 quantize
# --------------------------------------------------------------------------


def quantize(x: Tensor, inv_step, lim: float = 127.0) -> Tensor:
    """x f32 (any shape) -> int8 payload clip(round(x * inv_step), +-lim);
    inv_step is the exact pow2 reciprocal of the grid step (scalar)."""
    inv = _scalar(inv_step, x)
    if not _on_kernel(x):
        return ref.quantize(x, inv, lim)
    _need(x.dtype == torch.float32, "quantize takes fp32 input")
    xc = x.contiguous()
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    _launch("quantize", "quantize_launch", _ptr(xc), _ptr(inv), lim,
            _ptr(out), xc.numel(), _stream(xc))
    LAUNCHES["quantize"] += 1
    return out


# --------------------------------------------------------------------------
# K8 cq_stochastic
# --------------------------------------------------------------------------


def cq_stochastic(x: Tensor, bits: Tensor, inv_step,
                  dr: float = 128.0) -> Tensor:
    """Stochastic CQ payload (paper Eq. 7): x f32 and bits (the uint32
    random bits, as int32 or uint32) of one shape, inv_step the scalar
    rescale -> int16 clip(floor(v) + [u < v - floor(v)], +-(dr - 1)) with
    v = x * inv_step and u the low 24 bits of `bits` times 2^-24.  No path
    of the port calls it: the optimizer's CQ draws threefry noise
    (core/qfuncs.py), as the reference's does."""
    inv = _scalar(inv_step, x)
    if bits.dtype == torch.uint32:
        bits = bits.view(torch.int32)
    if not _on_kernel(x):
        return ref.cq_stochastic(x, bits, inv, dr)
    _need(x.dtype == torch.float32 and bits.dtype == torch.int32,
          "cq_stochastic takes fp32 x and 32-bit bits")
    _need(bits.shape == x.shape and bits.device == x.device,
          "cq_stochastic: x and bits differ in shape or device")
    xc, bc = x.contiguous(), bits.contiguous()
    out = torch.empty(x.shape, dtype=torch.int16, device=x.device)
    _launch("quantize", "cq_launch", _ptr(xc), _ptr(bc), _ptr(inv),
            float(dr), _ptr(out), xc.numel(), _stream(xc))
    LAUNCHES["cq_stochastic"] += 1
    return out


# --------------------------------------------------------------------------
# K3 dgrad / wgrad
# --------------------------------------------------------------------------

_BWD_MODES = {("affine", 8): 0, ("affine", 16): 1, ("flag", 8): 2}


def _bwd_mode(mode: str, k: int) -> int:
    key = (mode, 8 if mode == "affine" and k <= 8 else k)
    _need(key in _BWD_MODES,
          f"backward kernel takes affine k <= 8, affine k = 16 and flag "
          f"k = 8 (got {mode} k={k})")
    return _BWD_MODES[key]


def _bwd_splits(tiles: int, ktiles: int, sms: int) -> tuple[int, int]:
    """Split the contraction when the output tiles cannot fill the card
    (one wave); returns (splits, k tiles per split)."""
    want = max(1, min(ktiles, sms // max(tiles, 1)))
    per = -(-ktiles // want)
    return -(-ktiles // per), per


def _bwd_kernel(g, x8, scal, mode, k, dgrad_: bool) -> Tensor:
    md = _bwd_mode(mode, k)
    _need(g.dtype == torch.float32 and x8.dtype == torch.int8
          and g.dim() == 2 and x8.dim() == 2,
          "dgrad/wgrad take a 2-D f32 error and a 2-D int8 payload")
    gc, xc = g.contiguous(), x8.contiguous()
    sc = scal.to(device=g.device, dtype=torch.float32).contiguous()
    _need(sc.numel() == 3, "scal is [inv, s1, s2]")
    m, n = gc.shape
    if dgrad_:
        kd = xc.shape[0]
        _need(xc.shape[1] == n, f"dgrad shapes {tuple(g.shape)} x "
              f"{tuple(x8.shape)}")
        rows, cols, depth = m, kd, n
    else:
        kd = xc.shape[1]
        _need(xc.shape[0] == m, f"wgrad shapes {tuple(x8.shape)} x "
              f"{tuple(g.shape)}")
        rows, cols, depth = kd, n, m
    # the operand pass writes 128 x 128-byte tiles: the error's planes (two
    # for affine k = 16 and flag) and the int8 operand, on A's or B's side
    rt, ct, kt = -(-rows // 128), -(-cols // 128), -(-depth // 128)
    np_ = 1 if md == 0 else 2
    na, nb = (np_, 1) if dgrad_ else (1, np_)
    abuf = torch.empty(na * rt * kt * 16384, dtype=torch.uint8,
                       device=g.device)
    bbuf = torch.empty(nb * ct * kt * 16384, dtype=torch.uint8,
                       device=g.device)
    sms = torch.cuda.get_device_properties(g.device).multi_processor_count
    splits, kper = _bwd_splits(rt * ct, kt, sms)
    _need(rt < 65536 and ct < 65536 and splits < 65536, "backward kernel: "
          "output too large or too many splits for one launch")
    out = torch.empty((rows, cols), dtype=torch.float32, device=g.device)
    ws1 = ws2 = None
    if splits > 1:
        ws1 = torch.zeros((rows, cols), dtype=torch.int32, device=g.device)
        if md == 2:
            ws2 = torch.zeros_like(ws1)
    lim = 2.0 ** (k - 1) - 1.0
    _launch("backward", "bwd_launch", _ptr(gc), _ptr(xc), _ptr(sc),
            _ptr(out), _ptr(ws1), _ptr(ws2), _ptr(abuf), _ptr(bbuf), md,
            int(dgrad_), lim, m, n, kd, splits, kper, _stream(gc))
    return out


def dgrad(g: Tensor, b8: Tensor, scal: Tensor, *, mode: str,
          k: int = 8) -> Tensor:
    """Input-error dot of Alg. 2, e4 = Qe(g) . b8^T: g (M, N) f32, b8
    (K, N) int8 payload of the weight, scal (3,) f32 [inv, s1, s2] (the
    payload step's reciprocal and the planes' output scales).  Q_E2 runs in
    the kernel's prologue (mode "affine" k <= 8 or 16, or "flag" k = 8);
    no integer error tensor is stored.  Returns (M, K) f32."""
    if not _on_kernel(g):
        return ref.dgrad(g, b8, scal, mode=mode, k=k)
    out = _bwd_kernel(g, b8, scal, mode, k, True)
    LAUNCHES["dgrad"] += 1
    return out


def wgrad(a8: Tensor, g: Tensor, scal: Tensor, *, mode: str,
          k: int = 8) -> Tensor:
    """Weight-gradient dot of Alg. 2, g_W = a8^T . Qe(g): a8 (M, K) int8
    payload of the saved input, g (M, N) f32; same prologue and scal as
    `dgrad`.  Returns (K, N) f32."""
    if not _on_kernel(g):
        return ref.wgrad(a8, g, scal, mode=mode, k=k)
    out = _bwd_kernel(g, a8, scal, mode, k, False)
    LAUNCHES["wgrad"] += 1
    return out


# --------------------------------------------------------------------------
# K4 ubn_norm
# --------------------------------------------------------------------------

def ubn_cluster(m: int, sms: int) -> int:
    """Blocks that one row of K4's "rms" and "layer" kinds spreads over (a
    thread-block cluster): the most of 8, 4 and 2 that keeps M x blocks
    within the card's `sms` SMs, else 1 (a block a row).  From M alone: on
    132 SMs, 8 for a decode step's 4 rows and a prefill page's 16, 4 up to
    33 rows, 2 up to 66, then 1 (the training shape's 4096)."""
    for cl in (8, 4, 2):
        if m * cl <= sms:
            return cl
    return 1


# K4 "batch": bytes of x a strip block holds in shared memory (of the 227 KB
# a block may have, beside 6.5 KB of partials and statistics)
UBN_TILE_BYTES = 208 * 1024


def ubn_batch_plan(m: int, n: int, sms: int) -> dict:
    """The launch plan of K4's "batch" kind for x (M, C) = (m, n) on a card
    of `sms` SMs (csrc/ubn.cu).

    "strip" where a strip of 16 columns over all M rows fits in the shared
    memory of a cluster of `cl` blocks (1, 2 or 4; each holds `rows` =
    ceil(M / cl) rows) and the strips give at least 0.9 x `sms` blocks: the
    smallest such cl; x is read once.  Otherwise "two_pass": chunks of
    `rows` = max(256, ceil(M / 128)) rows (at most 128 chunks, from M
    alone) of 32-column groups, then a normalize over spans of 256 rows.
    On 132 SMs a ResNet-50 step at batch 32 takes strips at 1568 x 512 (cl
    4), 1568 x 2048 (cl 1), 6272 x 512 (cl 4) and 6272 x 1024 (cl 2), and
    the two passes at the other seven shapes (the card's measurements in
    PERF.md chose this: a cluster of 8 blocks of 200 KB, the only strip
    that holds M = 25088, ran slower than the two passes)."""
    strips = -(-n // 16)
    for cl in (1, 2, 4):
        rows = -(-m // cl)
        if rows * 64 <= UBN_TILE_BYTES and 10 * strips * cl >= 9 * sms:
            return {"route": "strip", "cw": 16, "cl": cl, "rows": rows,
                    "chunks": 0, "span": 0, "groups": strips,
                    "blocks": strips * cl}
    return _ubn_two_pass(m, n)


def _ubn_two_pass(m: int, n: int) -> dict:
    """ubn_batch_plan's two-pass route: chunks from M alone."""
    rows = max(256, -(-m // 128))
    return {"route": "two_pass", "cw": 32, "cl": 1, "rows": rows,
            "chunks": -(-m // rows), "span": 256, "groups": -(-n // 32),
            "blocks": -(-n // 32) * -(-m // rows)}


# the arrival counters of K4 batch's two-pass route, per device: zeroed
# once; each launch leaves them at 0 (the last block of a group resets its)
_UBN_COUNTS: dict = {}


def _ubn_counts(dev: torch.device, groups: int) -> Tensor:
    buf = _UBN_COUNTS.get(dev)
    if buf is None or buf.numel() < groups:
        buf = torch.zeros(max(groups, 256), dtype=torch.int32, device=dev)
        _UBN_COUNTS[dev] = buf
    return buf


_UBN_PLANS: dict = {}


def ubn_norm(x: Tensor, gamma: Tensor, beta: Tensor | None = None, *,
             kind: str = "rms", k_mu: int = 16, k_sigma: int = 16,
             k_bn: int = 16, k_gamma: int = 8, k_beta: int = 8,
             eps: float = 2.0 ** -8) -> Tensor:
    """Fused UBN over a 2-D view: x (M, N) f32, rows are tokens for "rms"
    and "layer"; for "batch" the statistics run down each column over all
    M rows (x is the NHWC activation flattened to (N*H*W, C)).  Returns
    (M, N) f32 on the k_BN/k_gamma grid."""
    kw = dict(kind=kind, k_mu=k_mu, k_sigma=k_sigma, k_bn=k_bn,
              k_gamma=k_gamma, k_beta=k_beta, eps=eps)
    if not _on_kernel(x):
        return ref.ubn_norm(x, gamma, beta, **kw)
    _need(kind in ("rms", "layer", "batch"), "unknown UBN kind {!r}", kind)
    _need(x.dim() == 2 and x.dtype == torch.float32, "ubn_norm takes (M, N) f32")
    _need(kind == "rms" or beta is not None, "ubn_norm {} needs beta", kind)
    xc = x.contiguous()
    m, n = xc.shape
    g = _as(gamma, torch.float32, xc)
    b = g if beta is None else _as(beta, torch.float32, xc)
    _need(g.numel() == n and b.numel() == n, "ubn_norm gamma/beta width")
    out = torch.empty_like(xc)
    s = lambda k: 2.0 ** (k - 1)  # noqa: E731
    widths = (s(k_mu), s(k_sigma), s(k_bn), s(k_gamma), s(k_beta), eps)
    if kind == "batch":
        # a strip over a cluster (one launch, x read once) or the two
        # passes (partials with the statistics folded in, then the
        # normalize), as ubn_batch_plan says (csrc/ubn.cu)
        key = (m, n, _sm_count(xc.device))
        p = _UBN_PLANS.get(key)
        if p is None:
            p = _UBN_PLANS[key] = ubn_batch_plan(*key)
        _need(m < 2 ** 31 and -(-m // max(p["span"], 1)) < 65536,
              "ubn_norm batch: M = {} out of range", m)
        vec = 4 if n % 4 == 0 and not xc.data_ptr() % 16 else 1
        work = count = None
        if p["route"] == "two_pass":
            # one workspace: the float64 partials, then the statistics
            work = torch.empty(8 * p["chunks"] * 2 * n + 16 * n,
                               dtype=torch.uint8, device=x.device)
            count = _ubn_counts(x.device, p["groups"])
        _launch("ubn", "ubn_batch_launch", _ptr(xc), _ptr(g), _ptr(b),
                _ptr(out), _ptr(work), _ptr(count), m, n,
                int(p["route"] == "two_pass"), vec, p["cw"], p["cl"],
                p["rows"], p["chunks"], p["span"], *widths, _stream(xc))
    else:
        # one launch: a row over a cluster of `cl` blocks (ubn_cluster),
        # float4 groups where N and every pointer allow (csrc/ubn.cu)
        cl = ubn_cluster(m, _sm_count(xc.device))
        vec = 4 if n % 4 == 0 and not (xc.data_ptr() | g.data_ptr()
                                       | b.data_ptr() | out.data_ptr()) % 16 \
            else 1
        _need(m * cl < 2 ** 31, f"ubn_norm: M = {m} out of range")
        _launch("ubn", "ubn_launch", _ptr(xc), _ptr(g), _ptr(b), _ptr(out),
                m, n, int(kind == "layer"), cl, vec, *widths, _stream(xc))
    LAUNCHES["ubn_norm"] += 1
    return out


# edge values of fp32_rounding_mismatches' divisions (and their negatives);
# 2^-8 and the two after it are the smallest divisors of K4 batch's
# normalize (sigma_q + eps, eps = 2^-8, sigma_q on the 2^-15 grid)
_FP32_EDGES = (0.0, 2.0 ** -8, 2.0 ** -8 + 2.0 ** -15, 2.0 ** -8 + 2.0 ** -23,
               2.0 ** -149, 3 * 2.0 ** -149, 2.0 ** -127,
               2.0 ** -126 - 2.0 ** -149, 2.0 ** -126, 2.0 ** -126 + 2.0 ** -149,
               1e-38, 1e-30, 2.0 ** -24, 0.1, 0.5, 1.0 - 2.0 ** -24, 1.0,
               1.0 + 2.0 ** -23, 1.5, 3.0, 7.0, 10.0, 2.0 ** 24 + 2.0, 1e10,
               1e30, 2.0 ** 127, 3.4028234663852886e38, math.inf, math.nan)


def fp32_rounding_mismatches(device, pairs: int = 2 ** 28) -> list[int]:
    """The fp32 __fdiv_rn and __fsqrt_rn that K4 and K6 use, against
    the float64 operation rounded once that their plain versions use, on
    the card: the counts of [`pairs` random divisions, divisions of every
    pair of edge values (denormal, tiny, huge, inf, NaN and negatives),
    square roots of all 2^32 bit patterns] that differ (all must be 0)."""
    _need(torch.device(device).type == "cuda", "the fp32 check runs on the "
          "card")
    edge = torch.tensor([v for x in _FP32_EDGES for v in (x, -x)],
                        dtype=torch.float32, device=device)
    miss = torch.zeros(3, dtype=torch.int64, device=device)
    _launch("ubn", "fp32_check_launch", pairs, _ptr(edge), edge.numel(),
            _ptr(miss), _stream(edge))
    return [int(v) for v in miss.cpu()]


# --------------------------------------------------------------------------
# K7 page_gather
# --------------------------------------------------------------------------


def _head_major(x: Tensor) -> Tensor:
    """(B, NB, page, KV, dh) -> (B, KV, NB * page, dh)."""
    b, nb, page, kv, dh = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(b, kv, nb * page, dh)


def page_gather(pages: Tensor, table: Tensor, *, pages2: Tensor | None = None,
                head_major: bool = False):
    """pages (P, page, *rest) int8 + table (B, NB) page ids (clamped; 0 is
    the trash page) -> (B, NB, page, *rest) int8, no dequantize.

    pages2, a second pool of the same shape (V beside K), is gathered
    through the same table in the same launch; the result is then the
    pair.  head_major, for pages (P, page, KV, dh), gives (B, KV, NB * page,
    dh) instead: each head's positions in one run, the layout the prefill
    contractions read without a copy."""
    if not _on_kernel(pages):
        outs = [ref.page_gather(p, table)
                for p in ((pages,) if pages2 is None else (pages, pages2))]
        if head_major:
            outs = [_head_major(o) for o in outs]
        return outs[0] if pages2 is None else tuple(outs)
    shape = pages.shape
    _need(pages.dtype == torch.int8 and (pages2 is None or (
        pages2.dtype == torch.int8 and pages2.shape == shape
        and pages2.device == pages.device)),
        "page_gather takes int8 pools of one shape on one device")
    _need(shape[0] > 0 and (not head_major or len(shape) == 4),
          "page_gather takes pages (P, page, ..) with P > 0, (P, page, KV, "
          "dh) for head_major")
    if not pages.is_contiguous():
        pages = pages.contiguous()
    p2 = pages
    if pages2 is not None:
        p2 = pages2 if pages2.is_contiguous() else pages2.contiguous()
    dev = pages.device
    tb = table
    if tb.dtype != torch.int32 or tb.device != dev or not tb.is_contiguous():
        tb = tb.to(device=dev, dtype=torch.int32).contiguous()
    b, nb = tb.shape
    page = shape[1]
    kv = shape[2] if len(shape) >= 4 else 1
    row = math.prod(shape[2:]) // kv
    out_shape = (b, kv, nb * page, row) if head_major else (b, nb) + shape[1:]
    pools = 1 if pages2 is None else 2
    # both pools' results in one allocation (the call is bound by host work)
    out = torch.empty(out_shape if pools == 1 else (2,) + out_shape,
                      dtype=torch.int8, device=dev)
    size = math.prod(out_shape)
    _need(b < 65536 and nb * kv < 2 ** 31, "page_gather table too large")
    if size:
        _launch("page_gather", "page_gather_launch", pages.data_ptr(),
                p2.data_ptr(), tb.data_ptr(), out.data_ptr(),
                out.data_ptr() + size, pools, shape[0], b, nb, page, kv, row,
                int(head_major), _stream(tb))
        LAUNCHES["page_gather"] += 1
    return out if pools == 1 else out.unbind(0)


# --------------------------------------------------------------------------
# K6 paged_attention
# --------------------------------------------------------------------------


def pa_span(b: int, kv: int, t: int, sms: int) -> int:
    """Positions a block of K6 sweeps: the largest of 128 and 64 whose grid
    of B x KV x ceil(T / span) blocks gives each of the card's `sms` SMs
    four, else 32 (from the shapes alone: the positions live on the card).
    A decode step of four lanes over 512 positions takes 32; sixteen
    lanes over 2048 take 128."""
    for span in (128, 64):
        if b * kv * -(-t // span) >= 4 * sms:
            return span
    return 32


def pa_sweep(q_pos: Tensor, t_valid, t: int, kq: float, sm_scale: float,
             dh: int) -> Tensor:
    """The positions each lane's sweep covers, as K6 computes them on the
    card (csrc/paged_attention.cu sweep_len): end = min(q_pos + 1, t_valid,
    T); all T where end <= 0 (no live position: every position is masked)
    or where a score could reach within 200 of the mask value -1e9
    (128 * 128 * dh * |kq| * |sm_scale| >= 9e8, kq = q_scale * k_scale in
    fp32), so that past `end` every exp(score - m) is exactly 0."""
    end = torch.clamp(torch.minimum(q_pos.long() + 1,
                                    torch.as_tensor(t_valid).long()), max=t)
    safe = 16384.0 * dh * abs(float(kq)) * abs(float(sm_scale)) < 9.0e8
    return torch.where((end > 0) & safe, end, torch.full_like(end, t))


def pa_layout(b: int, kv: int, g: int, dh: int, t: int, span: int) -> dict:
    """Byte offsets into K6's one workspace: the part its first launch
    zeroes (the int32 p.v accumulator (B, H, dh), then 2 * B * KV + 1
    counters), the probability step pair, m and l (B, H) fp32 each, the
    spans' float64 sums of exp and their maxima (B, H, ceil(T / span))
    each, and the scores (B, H, T) fp32; 16-byte aligned."""
    h, nspan = kv * g, -(-t // span)
    up = lambda x: -(-x // 16) * 16  # noqa: E731
    zero = up(4 * b * h * dh + 4 * (2 * b * kv + 1))
    ml = zero + 16
    lsum = up(ml + 8 * b * h)
    smax = lsum + 8 * b * h * nspan
    e = up(smax + 4 * b * h * nspan)
    return {"zero": zero, "glue": zero, "ml": ml, "lsum": lsum,
            "smax": smax, "e": e, "total": e + 4 * b * h * t}


def _paged_attention_kernel(q8, k_pages, v_pages, table, q_pos, t_valid,
                            q_scale, k_scale, v_scale, sm_scale, k_a,
                            want_p8: bool) -> dict:
    _need(q8.dtype == torch.int8 and k_pages.dtype == torch.int8
          and v_pages.dtype == torch.int8, "paged_attention takes int8")
    p_cnt, page, kv, dh = k_pages.shape
    b, h, dh2 = q8.shape
    _need(dh2 == dh and h % kv == 0 and v_pages.shape == k_pages.shape
          and p_cnt > 0, "paged_attention head shapes")
    g = h // kv
    _need(dh % 16 == 0 and dh <= 256 and g <= 64,
          f"paged_attention kernel takes dh % 16 == 0, dh <= 256, g <= 64 "
          f"(got dh={dh}, g={g})")
    qc, kc, vc = _aligned(q8), _aligned(k_pages), _aligned(v_pages)
    tb, qp = _as(table, torch.int32, qc), _as(q_pos, torch.int32, qc)
    nb = tb.shape[1]
    t = nb * page
    _need(0 < t < 2 ** 31 and b < 65536 and kv < 65536,
          "paged_attention: table or lanes out of range")
    # t_valid as the kernel's argument where it is a host integer (no copy
    # to the card), else a one-element int32 tensor on the card
    tv, tv_imm = None, 0
    if isinstance(t_valid, Tensor):
        tv = _as(t_valid, torch.int32, qc)
    else:
        tv_imm = max(-2 ** 31, min(int(t_valid), 2 ** 31 - 1))
    qs, ks, vs = (_scalar(s, qc) for s in (q_scale, k_scale, v_scale))
    span = pa_span(b, kv, t, _sm_count(qc.device))
    lay = pa_layout(b, kv, g, dh, t, span)
    ws = torch.empty(lay["total"], dtype=torch.uint8, device=qc.device)
    out = torch.empty((b, h, dh), dtype=torch.float32, device=qc.device)
    p8 = (torch.empty((b, h, t), dtype=torch.int8, device=qc.device)
          if want_p8 else None)
    s_ = 2.0 ** (k_a - 1)
    _launch("paged_attention", "pa_launch", _ptr(qc), _ptr(kc), _ptr(vc),
            _ptr(tb), _ptr(qp), _ptr(tv), tv_imm, _ptr(qs), _ptr(ks),
            _ptr(vs), sm_scale, s_, s_ - 1.0, b, p_cnt, page, kv, g, dh, nb,
            span,
            ws.data_ptr(), lay["zero"], lay["glue"], lay["ml"], lay["lsum"],
            lay["smax"], lay["e"], _ptr(out), _ptr(p8), _stream(qc))
    LAUNCHES["paged_attention"] += 1
    if not want_p8:
        return {"out": out}
    ml = ws[lay["ml"]:lay["ml"] + 8 * b * h].view(torch.float32).view(2, b, h)
    return {"m": ml[0], "l": ml[1], "p8": p8, "out": out}


def paged_attention_parts(q8, k_pages, v_pages, table, q_pos, t_valid,
                          q_scale, k_scale, v_scale, *, sm_scale: float,
                          k_a: int = 8) -> dict:
    """`paged_attention` with its intermediates {m, l, p8, out} (for the
    kernel-against-plain checks: m exact, l in ulps, p8 flip rate)."""
    if not _on_kernel(q8):
        return ref.paged_attention_parts(
            q8, k_pages, v_pages, table, q_pos, t_valid, q_scale, k_scale,
            v_scale, sm_scale=sm_scale, k_a=k_a)
    return _paged_attention_kernel(q8, k_pages, v_pages, table, q_pos,
                                   t_valid, q_scale, k_scale, v_scale,
                                   sm_scale, k_a, True)


def paged_attention(q8: Tensor, k_pages: Tensor, v_pages: Tensor,
                    table: Tensor, q_pos: Tensor, t_valid, q_scale, k_scale,
                    v_scale, *, sm_scale: float, k_a: int = 8) -> Tensor:
    """Fused paged decode attention.

    q8: (B, H, dh) int8 query payload (one decode token per lane);
    k_pages/v_pages: (P, page, KV, dh) int8 arenas; table: (B, NB) page ids
    (clamped; 0 = trash page); q_pos: (B,) positions; t_valid: bound on
    valid positions; q/k/v_scale: pow2 payload scales; sm_scale: 1/sqrt(dh);
    k_a: the probability grid width.  Returns (B, H, dh) f32, the pre-Q_A
    attention output."""
    if not _on_kernel(q8):
        return ref.paged_attention(q8, k_pages, v_pages, table, q_pos,
                                   t_valid, q_scale, k_scale, v_scale,
                                   sm_scale=sm_scale, k_a=k_a)
    return _paged_attention_kernel(q8, k_pages, v_pages, table, q_pos,
                                   t_valid, q_scale, k_scale, v_scale,
                                   sm_scale, k_a, False)["out"]


# --------------------------------------------------------------------------
# K5 flash_attention
# --------------------------------------------------------------------------


def flash_attention(q8: Tensor, k8: Tensor, v8: Tensor, q_pos: Tensor,
                    k_pos: Tensor, k_valid: Tensor, q_scale, k_scale,
                    v_scale, *, causal: bool, sm_scale: float, q_chunk: int,
                    kv_chunk: int, k_a: int = 8,
                    visits: Tensor | None = None) -> Tensor:
    """Tiled online-softmax attention on int8 payloads (training forward).

    q8: (B, S, H, dh) int8; k8/v8: (B, T, KV, dh) int8, pre-padded to chunk
    multiples; q_pos (S,), k_pos (T,) int; k_valid (T,) mask of real kv
    slots; q/k/v_scale: pow2 payload scales; q_chunk/kv_chunk: the
    quantization chunks.  Returns (B, S, H, dh) f32, the pre-Q_A output.

    The kernel takes dh a multiple of 16 up to 128 (zamba2's shared
    attention has 112; q.k runs over dh rounded up to 32 bytes of zero
    padding, p.v at that width with its columns past dh dropped), and
    kv_chunk a multiple of 64, or one ragged chunk
    (kv_chunk == T, a monolithic prefill's prompt shorter than the chunk):
    that one is padded here to the next multiple of 64 with zero payloads
    marked absent (k_valid -1 to the kernel), which changes no chunk amax
    and adds nothing to any sum, so the result is the plain version's at
    kv_chunk = T bit for bit.

    On the card, six launches (csrc/flash_attention.cu): the chunk
    statistics' init and each q, k and v chunk's payload amax (its grid
    step), the operand pass (q, k and v regridded once into the kernel's
    tiles), the statistics launch (each row's running max of masked scores
    per kv chunk, and the probability amax of each (q chunk, kv chunk)
    block) and the main launch.  k_a from 2 to 8.  `visits`, an int64 (2,)
    tensor on the card, gathers how many 64-position kv tiles the
    statistics and main launches visited out of B * KV * ceil(S * H / KV /
    128) * T / 64 each (the rest are skipped as wholly masked)."""
    scales = [_scalar(v, q8) for v in (q_scale, k_scale, v_scale)]
    if not _on_kernel(q8):
        return ref.flash_attention(
            q8, k8, v8, q_pos, k_pos, k_valid, *scales, causal=causal,
            sm_scale=sm_scale, q_chunk=q_chunk, kv_chunk=kv_chunk, k_a=k_a)
    _need(q8.dtype == torch.int8 and k8.dtype == torch.int8
          and v8.dtype == torch.int8, "flash_attention takes int8 payloads")
    _need(2 <= k_a <= 8, f"flash_attention kernel takes k_a from 2 to 8 "
          f"(got {k_a})")
    b, s, h, dh = q8.shape
    t, kv = k8.shape[1], k8.shape[2]
    _need(v8.shape == k8.shape and k8.shape[0] == b and k8.shape[3] == dh
          and h % kv == 0, "flash_attention head shapes")
    _need(s % q_chunk == 0 and t % kv_chunk == 0,
          "flash_attention operands must be padded to chunk multiples")
    _need((kv_chunk % 64 == 0 or kv_chunk == t) and dh % 16 == 0
          and 0 < dh <= 128,
          f"flash_attention kernel takes kv_chunk % 64 == 0 or one kv chunk, "
          f"and dh a multiple of 16 up to 128 (got kv_chunk={kv_chunk}, "
          f"T={t}, dh={dh})")
    dev = q8.device
    kvl = (k_valid != 0).to(device=dev, dtype=torch.int32)
    pad = -t % 64 if kv_chunk % 64 else 0
    if pad:     # one ragged chunk: absent keys up to a multiple of 64
        zeros = torch.zeros((b, pad, kv, dh), dtype=torch.int8, device=dev)
        k8, v8 = torch.cat([k8, zeros], 1), torch.cat([v8, zeros], 1)
        k_pos = torch.cat([k_pos.to(device=dev, dtype=torch.int32),
                           torch.zeros(pad, dtype=torch.int32, device=dev)])
        kvl = torch.cat([kvl, torch.full((pad,), -1, dtype=torch.int32,
                                         device=dev)])
        t = kv_chunk = t + pad
    nq, nk = s // q_chunk, t // kv_chunk
    nrb, nt = -(-s * (h // kv) // 128), t // 64
    _need(nrb < 65536 and kv < 65536 and b * max(nq, nk) < 65536,
          "flash_attention: too many query rows or chunks for one launch")
    _need(visits is None or (visits.dtype == torch.int64
                             and visits.numel() == 2
                             and visits.device == dev),
          "flash_attention visits is an int64 (2,) tensor on the card")
    qc8, kc8, vc8 = _aligned(q8), _aligned(k8), _aligned(v8)
    i32 = lambda x: x.to(device=dev, dtype=torch.int32).contiguous()  # noqa
    # scratch: the operand tiles (Q 128 rows x 128 bytes per row block, K
    # and V^T 8 KB per 64 positions), the tiles' mask summary, the p-code
    # thresholds and the chunk statistics
    u8 = dict(dtype=torch.uint8, device=dev)
    qr = torch.empty(b * kv * nrb * 16384, **u8)
    kr = torch.empty(b * kv * nt * 8192, **u8)
    vt = torch.empty(b * kv * nt * 8192, **u8)
    tinfo = torch.empty((nt, 4), dtype=torch.int32, device=dev)
    pthr = torch.empty(130, dtype=torch.float32, device=dev)
    stat = torch.empty(nq + 2 * nk + nq * nk, dtype=torch.int32, device=dev)
    m = torch.empty((b, s, h, nk), dtype=torch.float32, device=dev)
    out = torch.empty((b, s, h, dh), dtype=torch.float32, device=dev)
    s_ = 2.0 ** (k_a - 1)
    qp, kp, kvl = i32(q_pos), i32(k_pos), kvl.contiguous()
    sc = torch.stack(scales)
    args = [_ptr(x) for x in (qc8, kc8, vc8, qp, kp, kvl, sc, m, out, qr, kr,
                              vt, tinfo, pthr, stat, visits)]
    dims = (float(sm_scale), s_, s_ - 1.0, int(causal), b, s, t, h, kv, dh,
            q_chunk, kv_chunk, _stream(qc8))
    for phase in (2, 0, 1):
        _launch("flash_attention", "fa_launch", phase, *args, *dims)
    LAUNCHES["flash_attention"] += 1
    return out


def flash_pcode_mismatches(device) -> list[int]:
    """K5's p code (a fast exp2 guess corrected by exact thresholds) against
    rint(float(exp(double(x))) * 2^(k_a-1)) for every fp32 x <= 0, on the
    card: the number of x that differ, for k_a = 2 .. 8 (all must be 0)."""
    _need(torch.device(device).type == "cuda", "the p code check runs on "
          "the card")
    thr = torch.empty(7 * 130, dtype=torch.float32, device=device)
    miss = torch.zeros(7, dtype=torch.int64, device=device)
    _launch("flash_attention", "fa_pcode_check", _ptr(thr), _ptr(miss),
            _stream(thr))
    return [int(v) for v in miss.cpu()]


# --------------------------------------------------------------------------
# K9 selective_scan
# --------------------------------------------------------------------------

SCAN_STATES = (4, 16)   # the N the kernel is instantiated for
SCAN_THREADS = 128      # a block: 128 / (N / 4) channels of one batch row
SCAN_PAGE = 16          # an S up to this is one staged tile
SCAN_BWD_CHUNK = 8      # K9b's steps recomputed from one checkpoint
SCAN_DTYPES = (torch.float32, torch.bfloat16)
SCAN_LAUNCH = {torch.float32: "sscan_launch",
               torch.bfloat16: "sscan_bf16_launch"}
SCAN_BWD_LAUNCH = {torch.float32: "sscan_bwd_launch",
                   torch.bfloat16: "sscan_bwd_bf16_launch"}


def sscan_plan(bsz: int, s: int, d: int, n: int, sms: int,
               esize: int = 4) -> dict:
    """The launch plan of K9 (csrc/selective_scan.cu) for a (B, S, D, N)
    scan of `esize`-byte operands (4: fp32, 2: bf16) on a card of `sms`
    SMs.  A channel's N states are split over `lanes` = N / 4 threads; a
    block takes `chans` = 128 / lanes channels.  S <= 1 (a decode step)
    takes the "direct" route; a longer S the "staged" one: a prefill page
    (S <= 16) is one tile of S steps, a longer S tiles of 4 steps in a
    ring of 4 stages (2 where more than three blocks must share an SM).
    bf16 at N = 4 always takes the direct route: a step's row of 4-state
    channels is 8 bytes a channel, too narrow for the 16-byte bulk copies.
    `smem` is a staged block's shared bytes."""
    lanes = n // 4
    chans = SCAN_THREADS // lanes
    blocks = bsz * -(-d // chans)
    if s <= 1 or esize * n < 16:
        return {"route": "direct", "lanes": lanes, "chans": chans,
                "blocks": blocks, "tile": 1, "stages": 0, "smem": 0}
    if s <= SCAN_PAGE:
        tile, stages = s, 1
    else:
        tile, stages = 4, 4 if -(-blocks // sms) <= 3 else 2
    smem = 64 + stages * tile * (2 * chans * n + n) * esize
    return {"route": "staged", "lanes": lanes, "chans": chans,
            "blocks": blocks, "tile": tile, "stages": stages, "smem": smem}


_SCAN_PLANS: dict = {}


def _aligned(t: Tensor) -> Tensor:
    """t contiguous with a 16-byte aligned start (the kernel's float4 loads
    and bulk copies); an operand that already is so is passed as it is, a
    view that starts off the alignment is copied."""
    if not t.is_contiguous():
        t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def selective_scan(a: Tensor, b: Tensor, c: Tensor,
                   h0: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Mamba1 selective scan h_t = a_t * h_{t-1} + b_t, y_t = c_t . h_t.

    a, b: (B, S, D, N); c: (B, S, N); h0: (B, D, N) carried state, or None
    for zeros (the TPU kernel's function); all f32, or all bf16 (the
    carriers of `scan_dtype="bf16"`: h stays fp32 inside, the outputs
    round to bf16).  Returns (y (B, S, D), h_last (B, D, N)) in the
    operands' dtype; on the card both are views of one allocation.  The
    kernel takes N in SCAN_STATES and B < 65536; other shapes and mixed
    dtypes raise ValueError.  Differentiable through `_SelectiveScan`,
    whose backward is `selective_scan_bwd` (K9b on the card)."""
    return _SelectiveScan.apply(a, b, c, h0)


class _SelectiveScan(torch.autograd.Function):
    """K9 forward (unchanged: the same bits and plan), K9b backward.  Saves
    a, b, c and h0; the backward recomputes every h_t from them."""

    @staticmethod
    def forward(ctx, a, b, c, h0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(a, b, c, h0)
        return _scan_forward(a, b, c, h0)

    @staticmethod
    def backward(ctx, dy, dh_last):
        a, b, c, h0 = ctx.saved_tensors
        if dy is None:
            dy = a.new_zeros(a.shape[:3])
        da, db, dc, dh0 = selective_scan_bwd(a, b, c, dy, h0, dh_last)
        return da, db, dc, dh0


def _scan_checks(op: str, a: Tensor, b: Tensor, c: Tensor,
                 h0: Tensor | None, **more) -> None:
    """The operand checks K9 and K9b share; `more` holds further (B, D, N)
    or (B, S, D) operands by name.  Every operand is f32, or every one
    bf16."""
    _need(a.dim() == 4 and a.dtype in SCAN_DTYPES and b.dtype == a.dtype
          and c.dtype == a.dtype, "{} takes (B, S, D, N) a and b and "
          "(B, S, N) c, all f32 or all bf16; got {}, {}, {}", op, a.dtype,
          b.dtype, c.dtype)
    bsz, s, d, n = a.shape
    _need(b.shape == a.shape and c.shape == (bsz, s, n),
          "{} shapes a {}, b {}, c {}", op, tuple(a.shape), tuple(b.shape),
          tuple(c.shape))
    _need(n in SCAN_STATES, "{} kernel is built for N in {} (a thread holds "
          "4 states), got N = {}", op, SCAN_STATES, n)
    _need(0 < bsz < 65536 and d > 0, "{}: B = {}, D = {} out of the "
          "kernel's grid", op, bsz, d)
    _need(b.device == a.device and c.device == a.device,
          "{} operands on different devices", op)
    for name, t in dict(more, h0=h0).items():
        if t is None:
            continue
        want = (bsz, s, d) if name == "dy" else (bsz, d, n)
        _need(t.shape == want and t.dtype == a.dtype
              and t.device == a.device, "{} {} {} {} is not {} {}", op,
              name, tuple(t.shape), t.dtype, want, a.dtype)


def _scan_forward(a: Tensor, b: Tensor, c: Tensor,
                  h0: Tensor | None) -> tuple[Tensor, Tensor]:
    if not _on_kernel(a):
        return ref.selective_scan(a, b, c, h0)
    _scan_checks("selective_scan", a, b, c, h0)
    bsz, s, d, n = a.shape
    if h0 is not None:
        h0 = _aligned(h0)
    ac, bc, cc = _aligned(a), _aligned(b), _aligned(c)
    es = a.element_size()
    key = (bsz, s, d, n, _sm_count(a.device), es)
    p = _SCAN_PLANS.get(key)
    if p is None:
        p = _SCAN_PLANS[key] = sscan_plan(*key)
    # one allocation: h_last first, so that its vector stores are aligned,
    # then y
    hn = bsz * d * n
    buf = torch.empty(hn + bsz * s * d, dtype=a.dtype, device=a.device)
    h_last = buf.as_strided((bsz, d, n), (d * n, n, 1))
    y = buf.as_strided((bsz, s, d), (s * d, d, 1), hn)
    _launch("selective_scan", SCAN_LAUNCH[a.dtype], _ptr(ac), _ptr(bc),
            _ptr(cc), _ptr(h0), buf.data_ptr() + es * hn, _ptr(buf), bsz, s,
            d, n, int(p["route"] == "staged"), p["tile"], p["stages"],
            _stream(ac))
    LAUNCHES["selective_scan"] += 1
    return y, h_last


def selective_scan_bwd(a: Tensor, b: Tensor, c: Tensor, dy: Tensor,
                       h0: Tensor | None = None,
                       dh_last: Tensor | None = None):
    """The gradient of `selective_scan` (K9b): (da, db (B, S, D, N),
    dc (B, S, N), dh0 (B, D, N) or None without h0) from the forward's
    operands, dy (B, S, D) and dh_last (B, D, N) or None, all in the
    operands' dtype (f32 or bf16).  The numerics and the order of dc's
    sum are `ref.selective_scan_bwd`'s.

    On the card: one kernel launch runs the forward once more, leaving the
    state before every chunk of 8 steps in da's first step of that chunk
    (fp32; bf16 carriers cannot hold it, so there a (B, ceil(S / 8), D, N)
    fp32 buffer takes it), then walks the chunks backwards, recomputing
    each chunk's h from its checkpoint before da overwrites it, and writes
    each block's float64 dc partials; a second launch sums the partials in
    block order.  Takes the shapes and dtypes K9 takes; others raise
    ValueError."""
    if not _on_kernel(a):
        return ref.selective_scan_bwd(a, b, c, dy, h0, dh_last)
    _scan_checks("selective_scan_bwd", a, b, c, h0, dy=dy, dh_last=dh_last)
    bsz, s, d, n = a.shape
    ac, bc, cc = _aligned(a), _aligned(b), _aligned(c)
    h0c = None if h0 is None else _aligned(h0)
    dhc = None if dh_last is None else _aligned(dh_last)
    dyc = dy.contiguous()
    w, q = ref.scan_dc_groups(n)
    tiles = -(-d // (w * q))
    da, db = torch.empty_like(ac), torch.empty_like(ac)
    part = torch.empty((bsz, s, tiles, n), dtype=torch.float64,
                       device=a.device)
    dc = torch.empty((bsz, s, n), dtype=a.dtype, device=a.device)
    dh0 = None if h0 is None else torch.empty_like(h0c)
    args = [_ptr(ac), _ptr(bc), _ptr(cc), _ptr(h0c), _ptr(dyc), _ptr(dhc),
            _ptr(da), _ptr(db), _ptr(part), _ptr(dc), _ptr(dh0)]
    if a.dtype == torch.bfloat16:       # the fp32 checkpoints' own buffer
        ck = torch.empty((bsz, -(-s // SCAN_BWD_CHUNK), d, n),
                         dtype=torch.float32, device=a.device)
        args.append(_ptr(ck))
    _launch("selective_scan_bwd", SCAN_BWD_LAUNCH[a.dtype], *args, bsz, s,
            d, n, _stream(ac))
    LAUNCHES["selective_scan_bwd"] += 1
    return da, db, dc, dh0


OPS = tuple(LAUNCHES)
