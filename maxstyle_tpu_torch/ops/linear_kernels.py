"""Float32 linear maps on the split-TF32 GEMM of ``csrc/linear.cu``.

``models/layers.Linear`` sends a float32 input on a CUDA device here
(:func:`linear`); CPU tensors, and any other compute dtype, keep
``F.linear``. One kernel, ``linear_gemm``, computes C(p, q) = sum_r A(p, r)
B(q, r) with float32's accuracy on the tensor cores (three TF32 products of
split operands; the note in the CUDA source says why and how), and carries
the layer's three products, one launch each:

* :func:`linear_fwd` — y = x W^T + b, the bias added in the kernel;
* :func:`linear_dx` — dx = dy W;
* :func:`linear_dw` — dW = dy^T x and, where asked, db = sum of dy over the
  tokens, in the same launch.

The kernel reads B with the contraction along its rows, so dW hands it the
smaller of x^T and dy^T (with dy^T it computes dW^T, and db is a sum of its
own), and dx, where the tokens are C's rows, W^T: one copy each before the
launch (:func:`_transposed`).

:class:`_Linear` ties them into one autograd node. Its backward launches a
product only for an input whose gradient the autograd engine will use: in
``torch.autograd.grad`` taken with respect to other leaves (the MaxStyle
inner loop's style tensors), ``ctx.needs_input_grad`` still reads True for
the weight and the bias, but the engine does not run their accumulation, so
neither dW nor db is computed there.

The kernel's tiles are 128 rows by 48, 96 or 144 columns; :func:`plan`
chooses the columns, and where the contraction may be cut over blocks
(dW), how far, from the shape and the card's SMs by a model of the kernel's
time; :func:`_oriented` lets the tokens be the rows or the columns of C,
whichever the model prefers. No model name and no option decide it.

Each product takes its plain version (``F.linear``, ``mm``, ``sum``) for CPU
tensors only; for a CUDA tensor it launches the kernel or raises.
``ASKED`` counts the products the backward computed, on either device.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from maxstyle_tpu_torch import kernels

ROWS = 128                 # rows of C a tile
BK = 32                    # contraction values a k-block
COLUMNS = (48, 96, 144)    # the tile widths the kernel is built for
# the time model of :func:`plan`: an SM's TF32 multiply-adds a clock on the
# tensor cores and its share of L2's bytes a clock; the clocks a k-block and
# a tile cost beyond that; the SM's clock under load; device memory's bytes
# a second and the share of that rate at which atomic additions land
MACS_PER_CLOCK = 1024
L2_BYTES_PER_CLOCK = 11.5
KB_CLOCKS = 300
TILE_CLOCKS = 1500
CLOCK_HZ = 1.755e9
HBM_BYTES_PER_S = 3.35e12
ATOMIC_SHARE = 1.0
# the most shares a contraction is cut into: enough for a dW whose output
# is one tile (Swin's 48 x 48) to fill the card's SMs
MAX_SPLITS = 128

ASKED = {"dx": 0, "dw": 0, "db": 0}


def reset_asked() -> None:
    for name in ASKED:
        ASKED[name] = 0


def model_seconds(p: int, q: int, r: int, columns: int, kb_per: int, sms: int) -> float:
    """The time model of one launch: the card runs its tiles (128 x columns,
    each contraction cut into shares of ``kb_per`` k-blocks of 32) in waves
    of ``sms``, a k-block taking three TF32 products of 128 x columns x 32
    at MACS_PER_CLOCK or its two tiles' bytes from L2, whichever is longer,
    and KB_CLOCKS more; or
    it moves A, B and C at the memory's rate, whichever is longer; plus the
    atomic additions of the shares where the contraction is cut."""
    kb_total = -(-r // BK)
    shares = -(-kb_total // kb_per)
    tiles = -(-p // ROWS) * -(-q // columns) * shares
    per_kb = max(3 * ROWS * columns * BK / MACS_PER_CLOCK,
                 4 * (ROWS + columns) * BK / L2_BYTES_PER_CLOCK)
    per_kb += KB_CLOCKS
    clocks = -(-tiles // sms) * (kb_per * per_kb + TILE_CLOCKS)
    nbytes = 4 * (p * r + q * r + p * q)
    atomics = 0 if shares == 1 else 4 * p * q * shares / (ATOMIC_SHARE * HBM_BYTES_PER_S)
    return max(clocks / CLOCK_HZ, nbytes / HBM_BYTES_PER_S) + atomics


@functools.lru_cache(maxsize=None)
def plan(p: int, q: int, r: int, sms: int, can_split: bool = False) -> Tuple[int, int, float]:
    """(columns, kb_per, modelled seconds) of C [p, q] over a contraction of
    r: the tile width of COLUMNS and the k-blocks a share (all of them
    unless ``can_split``) that :func:`model_seconds` finds fastest; on a tie
    the wider tile and the fewer shares."""
    kb_total = -(-r // BK)
    cuts = sorted({-(-kb_total // s) for s in range(1, min(kb_total, MAX_SPLITS) + 1)},
                  reverse=True) if can_split else [kb_total]
    best = None
    for columns in sorted(COLUMNS, reverse=True):
        for kb_per in cuts:
            t = model_seconds(p, q, r, columns, kb_per, sms)
            if best is None or t < best[2] * (1 - 1e-9):
                best = (columns, kb_per, t)
    return best


@functools.lru_cache(maxsize=None)
def _oriented(tokens: int, features: int, r: int, sms: int) -> Tuple[bool, int, int]:
    """(tokens as C's rows, columns, kb_per) of a [tokens, features] output:
    the orientation :func:`plan` models faster, on a tie the one whose tiles
    cover less beyond C."""
    def padded(p, q, columns):
        return -(-p // ROWS) * ROWS * -(-q // columns) * columns

    rows_plan = plan(tokens, features, r, sms)
    cols_plan = plan(features, tokens, r, sms)
    if (rows_plan[2], padded(tokens, features, rows_plan[0])) \
            <= (cols_plan[2], padded(features, tokens, cols_plan[0])):
        return (True,) + rows_plan[:2]
    return (False,) + cols_plan[:2]


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the reference the kernel is held to)
# ---------------------------------------------------------------------------


def linear_fwd_plain(x2: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor]) -> torch.Tensor:
    return F.linear(x2, weight, bias)


def linear_dx_plain(dy2: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return dy2.mm(weight)


def linear_dw_plain(dy2: torch.Tensor, x2: torch.Tensor, need_db: bool = True):
    """(dW, db), db None where not asked for."""
    return dy2.t().mm(x2), dy2.sum(0) if need_db else None


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _operand(name: str, t: torch.Tensor, dev: int) -> torch.Tensor:
    """t as the kernel takes it: float32 on CUDA device ``dev``, contiguous,
    on a 16-byte boundary, its rows a multiple of 4 values."""
    if t.get_device() != dev or t.dtype is not torch.float32:
        raise ValueError(f"{name}: expected float32 tensors on one CUDA device, got {t.dtype} "
                         f"on {t.device}")
    if t.shape[-1] % 4:
        raise ValueError(f"{name}: the kernel takes rows of a multiple of 4 values, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _bias(name: str, bias: Optional[torch.Tensor], n: int, dev: int) -> Optional[torch.Tensor]:
    if bias is None:
        return None
    if bias.get_device() != dev or bias.dtype is not torch.float32 or bias.shape != (n,):
        raise ValueError(f"{name}: expected a float32 bias [{n}] on the input's device, got "
                         f"{bias.dtype} {tuple(bias.shape)} on {bias.device}")
    return bias if bias.is_contiguous() else bias.contiguous()


def _gemm(c, a, a_mn, lda, b, ldb, p, q, r, sp, sq, columns, kb_per, bias=None,
          bias_on_p=False, db=None) -> None:
    """One launch of ``linear_gemm`` on C = ``c``: A is ``a`` ([p, r], or
    [r, p] with ``a_mn``; rows ``lda`` values apart), B is ``b`` ([q, r];
    rows ``ldb`` apart), on c's device."""
    args = _ARGS.__dict__.get("values")
    if args is None:
        args = _ARGS.values = (ctypes.c_longlong * 16)()
    args[:] = (a.data_ptr(), b.data_ptr(), c.data_ptr(), 0 if bias is None else bias.data_ptr(),
               0 if db is None else db.data_ptr(), p, q, r, lda, ldb, sp, sq, a_mn, bias_on_p,
               columns, kb_per)
    rc = _entry()(args, torch._C._cuda_getCurrentRawStream(c.get_device()))
    if rc < 0:
        raise RuntimeError(f"CUDA kernel linear_gemm: the driver could not bind a context or "
                           f"encode a tensor map: CUresult {-rc}")
    if rc != 0:
        raise RuntimeError(f"CUDA kernel linear_gemm failed to launch: cudaError {rc}")


@functools.lru_cache(maxsize=None)
def _entry():
    return kernels.entry("linear_gemm")


# each thread's argument array for linear_gemm (the autograd engine runs the
# backward's products on a thread of its own)
_ARGS = threading.local()


def _transposed(t: torch.Tensor) -> torch.Tensor:
    """t [a, b] (contiguous) as a [b, a] matrix with contiguous rows, in one
    copy (``linear_transpose`` on the card): the kernel reads B with its
    contraction index along its rows. Its rows are padded to a multiple of
    4 values, which the kernel never reads."""
    a, b = t.shape
    out = t.new_empty((b, -(-a // 4) * 4))
    if t.is_cpu:
        out[:, :a].copy_(t.t())
    else:
        kernels.launch("linear_transpose", t, out, a, b, out.shape[1])
    return out


# The products on operands that passed the checks: float32 on one CUDA
# device, contiguous, on 16-byte boundaries, rows of a multiple of 4 values.
# x and dy may have any number of leading dimensions: their rows are the
# tokens.


def _fwd(x, weight, bias):
    k, n = x.shape[-1], weight.shape[0]
    m = x.numel() // k
    y = x.new_empty((*x.shape[:-1], n))
    tokens_rows, columns, kb_per = _oriented(m, n, k, sm_count(x.get_device()))
    if tokens_rows:
        _gemm(y, x, 0, k, weight, k, m, n, k, n, 1, columns, kb_per, bias)
    else:
        _gemm(y, weight, 0, k, x, k, n, m, k, 1, n, columns, kb_per, bias, 1)
    kernels.LAUNCHES["linear_fwd"] += 1
    return y


def _dx(dy, weight):
    n, k = weight.shape
    m = dy.numel() // n
    dx = dy.new_empty((*dy.shape[:-1], k))
    tokens_rows, columns, kb_per = _oriented(m, k, n, sm_count(dy.get_device()))
    if tokens_rows:
        _gemm(dx, dy, 0, n, _transposed(weight), n, m, k, n, k, 1, columns, kb_per)
    else:
        _gemm(dx, weight, 1, k, dy, n, k, m, n, 1, k, columns, kb_per)
    kernels.LAUNCHES["linear_dx"] += 1
    return dx


def _dw(dy, x, need_db):
    # both operands hold the contraction (the tokens) along their columns;
    # the smaller is copied transposed to be B. Where that is dy, C is
    # dW^T, written into dW's place, and db is a sum of its own
    n, k = dy.shape[-1], x.shape[-1]
    m = dy.numel() // n
    dw = dy.new_empty((n, k))
    sms = sm_count(dy.get_device())
    if n < k:
        columns, kb_per, _ = plan(k, n, m, sms, True)
        dyt = _transposed(dy.view(m, n))
        _gemm(dw, x, 1, k, dyt, dyt.shape[1], k, n, m, 1, k, columns, kb_per)
        db = dy.view(m, n).sum(0) if need_db else None
    else:
        columns, kb_per, _ = plan(n, k, m, sms, True)
        db = dy.new_empty((n,)) if need_db else None
        xt = _transposed(x.view(m, k))
        _gemm(dw, dy, 1, n, xt, xt.shape[1], n, k, m, k, 1, columns, kb_per, db=db)
    kernels.LAUNCHES["linear_dw"] += 1
    return dw, db


def linear_fwd(x2: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor]) -> torch.Tensor:
    """y [M, N] = x2 [M, K] weight[N, K]^T (+ bias [N])."""
    if x2.is_cpu:
        return linear_fwd_plain(x2, weight, bias)
    dev = x2.get_device()
    x2, weight = _operand("linear_fwd", x2, dev), _operand("linear_fwd", weight, dev)
    if weight.shape[1] != x2.shape[1]:
        raise ValueError(f"linear_fwd: shapes {tuple(x2.shape)}, {tuple(weight.shape)}")
    return _fwd(x2, weight, _bias("linear_fwd", bias, weight.shape[0], dev))


def linear_dx(dy2: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """dx [M, K] = dy2 [M, N] weight [N, K]."""
    if dy2.is_cpu:
        return linear_dx_plain(dy2, weight)
    dev = dy2.get_device()
    dy2, weight = _operand("linear_dx", dy2, dev), _operand("linear_dx", weight, dev)
    if weight.shape[0] != dy2.shape[1]:
        raise ValueError(f"linear_dx: shapes {tuple(dy2.shape)}, {tuple(weight.shape)}")
    return _dx(dy2, weight)


def linear_dw(dy2: torch.Tensor, x2: torch.Tensor, need_db: bool = True):
    """(dW [N, K] = dy2 [M, N]^T x2 [M, K], db [N] = dy2 summed over M or
    None where not asked for), one launch."""
    if dy2.is_cpu:
        return linear_dw_plain(dy2, x2, need_db)
    dev = dy2.get_device()
    dy2, x2 = _operand("linear_dw", dy2, dev), _operand("linear_dw", x2, dev)
    if x2.shape[0] != dy2.shape[0]:
        raise ValueError(f"linear_dw: shapes {tuple(dy2.shape)}, {tuple(x2.shape)}")
    return _dw(dy2, x2, need_db)


def _engine_runs(ctx) -> Tuple[bool, bool, bool]:
    """Whether the autograd engine will use the gradient of each input of
    this node in the backward that runs it. It answers False for a leaf
    (a weight) whose gradient nothing takes, and raises for a leaf that
    ``torch.autograd.grad`` was asked for, whose gradient is then used."""
    needs = ctx.needs_input_grad
    edges = ctx.next_functions

    def runs(i):
        if not needs[i]:
            return False
        try:
            return torch._C._will_engine_execute_node(edges[i][0])
        except RuntimeError:
            return True
    return runs(0), runs(1), runs(2)


class _Linear(torch.autograd.Function):
    """y = x weight^T + bias on the kernel (``F.linear`` on the CPU); the
    backward computes dx, dW and db each only where the engine uses it."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        if x.is_cpu:
            y = F.linear(x, weight, bias)
        else:
            # checked once here; the backward's products take these operands
            dev = x.get_device()
            x, weight = _operand("linear", x, dev), _operand("linear", weight, dev)
            if weight.shape[1] != x.shape[-1] or weight.shape[0] % 4:
                raise ValueError(f"linear: shapes {tuple(x.shape)}, {tuple(weight.shape)}")
            y = _fwd(x, weight, _bias("linear", bias, weight.shape[0], dev))
        ctx.save_for_backward(x, weight)
        return y

    @staticmethod
    def backward(ctx, dy):
        if torch.is_grad_enabled():
            raise RuntimeError("the linear kernel's backward is not differentiable "
                               "(create_graph=True)")
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b = _engine_runs(ctx)
        cpu = dy.is_cpu
        if cpu:
            dy2 = dy.reshape(-1, dy.shape[-1])
        else:
            # autograd hands dy in y's shape, dtype and device; only its
            # memory order can differ
            dy2 = dy if dy.is_contiguous() else dy.contiguous()
            if dy2.data_ptr() % 16:
                dy2 = dy2.clone()
        dx = dw = db = None
        if need_x:
            dx = linear_dx_plain(dy2, weight).view(x.shape) if cpu else _dx(dy2, weight)
            ASKED["dx"] += 1
        if need_w:
            dw, db = (linear_dw_plain(dy2, x.reshape(-1, x.shape[-1]), need_b) if cpu
                      else _dw(dy2, x, need_b))
            ASKED["dw"] += 1
        elif need_b:
            db = dy2.reshape(-1, dy2.shape[-1]).sum(0)
        ASKED["db"] += need_b
        return dx, dw, db


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.linear(x, weight, bias)`` for float32 x [..., K], weight [N, K],
    bias [N], on the kernel for a CUDA x, differentiable in all three."""
    return _Linear.apply(x, weight, bias)
