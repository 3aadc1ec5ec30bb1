"""Small batched products for the dot-precision probes, with their plain
versions.

``dot_chain`` runs a chain of batched products on row-major (batch, n, n)
operands in one of four forms and one of three dot modes; ``lane_dot_chain``
runs the spectral-axis-last (n, n, s) chain. CUDA tensors launch the
hand-written kernels of ``csrc/probe_dots.cu`` (counted in ``.launches``);
CPU tensors run the plain versions ``dot_chain_reference`` and
``lane_dot_chain_reference``, which repeat each mode's arithmetic in torch.
The probes of ``vsmartmom_tpu_torch/probes/`` drive them.

Forms (``dot_chain``):

* ``right``  x <- scale (x @ y), ``chain`` times (P1, P8);
* ``left``   acc <- x @ acc from acc = y, ``chain`` times (P2);
* ``sum``    acc = sum over k < ndot of (x + k) @ y (P3);
* ``single`` x @ y once (P6).

Dot modes, from the TPU's precisions (``MODE_OF_PRECISION``):

* ``fp32``   exact-f32 products (``torch.backends.cuda.matmul.allow_tf32``
  False in the plain version);
* ``tf32``   both operands rounded to TF32 (10-bit mantissa, to nearest,
  ties away from zero, as ``cvt.rna.tf32.f32``), products summed in FP32;
* ``3xtf32`` each operand split into a TF32 head and the TF32 rounding of
  its remainder, lo.hi + hi.lo + hi.hi summed in FP32.
"""

import contextlib
import ctypes

import torch

FORMS = ("right", "left", "sum", "single")
MODES = ("fp32", "tf32", "3xtf32")
#: The JAX dot precisions of the TPU probes and the H100 mode of each.
MODE_OF_PRECISION = {"highest": "fp32", "float32": "fp32", "high": "3xtf32",
                     "default": "tf32", None: "tf32"}
#: Largest n the kernel takes (three zero-padded operands in 227 KB).
KERNEL_MAX_N = 128

_FORM_CODE = {"right": 0, "left": 1, "sum": 2, "single": 0}
_MODE_CODE = {"fp32": 0, "tf32": 1, "3xtf32": 2}


@contextlib.contextmanager
def matmul_tf32(allowed):
    """FP32 products on the card with TF32 tensor cores allowed or not
    (``torch.backends.cuda.matmul.allow_tf32``) inside the block; the
    earlier setting comes back afterwards."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allowed
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def round_tf32(x):
    """float32 -> the nearest TF32 value (ties away from zero) by integer
    bit operations: add half a TF32 ulp to the magnitude bits, clear the low
    13. NaN stays NaN."""
    bits = x.contiguous().view(torch.int32)
    out = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isnan(x), x, out)


def split_tf32(x):
    """(head, tail): head = round_tf32(x), tail = round_tf32(x - head)."""
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def mode_matmul(a, b, mode):
    """a @ b with the arithmetic of dot mode ``mode``."""
    if mode == "fp32":
        return a @ b
    if mode == "tf32":
        return round_tf32(a) @ round_tf32(b)
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _check_form(form, mode, chain, ndot):
    if form not in FORMS:
        raise ValueError(f"form {form!r} not in {FORMS}")
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if chain < 1 or ndot < 1:
        raise ValueError(f"chain and ndot must be >= 1, got {chain}, {ndot}")
    if form == "single" and (chain != 1 or ndot != 1):
        raise ValueError("form 'single' is one product: chain = ndot = 1")


def dot_chain_reference(x, y, form, mode="fp32", chain=1, scale=1.0,
                        ndot=1):
    """The plain version of ``dot_chain``: the same forms with the mode's
    arithmetic in torch (f64 tensors give the f64 chain in mode fp32)."""
    _check_form(form, mode, chain, ndot)
    with matmul_tf32(False):
        if form in ("right", "single"):
            for _ in range(chain):
                x = mode_matmul(x, y, mode) * scale
            return x
        if form == "left":
            acc = y
            for _ in range(chain):
                acc = mode_matmul(x, acc, mode)
            return acc
        acc = torch.zeros_like(y)
        for k in range(ndot):
            acc = acc + mode_matmul(x + float(k), y, mode)
        return acc


def _lib():
    from .cuda_build import load
    lib = load("probe_dots")
    lib.vsm_probe_error_string.argtypes = [ctypes.c_int]
    lib.vsm_probe_error_string.restype = ctypes.c_char_p
    return lib


def _check_tensors(named):
    """float32, of the wanted shapes, on one CUDA device, contiguous: each
    property over all tensors before the next."""
    dev = named[0][1].device
    for name, x, _ in named:
        if x.dtype != torch.float32:
            raise ValueError(f"{name}: the kernel takes float32, got "
                             f"{x.dtype}")
    for name, x, want in named:
        if tuple(x.shape) != tuple(want):
            raise ValueError(f"{name}: shape {tuple(x.shape)} != "
                             f"{tuple(want)}")
    for name, x, _ in named:
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"{name}: the kernel takes tensors on one CUDA "
                             f"device, got {x.device}")
    for name, x, _ in named:
        if not x.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")


def _raise_on(rc, lib, what):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.vsm_probe_error_string(rc).decode())


def _launch_dot_chain(x, y, form, mode, chain, scale, ndot):
    """Check the operands, then one launch of the dot_chain kernel."""
    _check_form(form, mode, chain, ndot)
    if x.dim() != 3 or y.dim() != 3:
        raise ValueError("x and y must be (batch, n, n) and (batch, n, c)")
    batch, n = x.shape[0], x.shape[1]
    c = y.shape[-1] if form in ("sum", "single") else n
    if n > KERNEL_MAX_N:
        raise ValueError(f"the kernel takes n <= {KERNEL_MAX_N}, got n={n}")
    _check_tensors([("x", x, (batch, n, n)), ("y", y, (batch, n, c))])
    lib = _lib()
    fn = lib.vsm_dot_chain_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + \
        [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(y)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), batch, n, c,
                _FORM_CODE[form], _MODE_CODE[mode], chain, ndot,
                float(scale), stream)
    _raise_on(rc, lib, "dot_chain")
    return out


def dot_chain(x, y, form, mode="fp32", chain=1, scale=1.0, ndot=1):
    """A chain of batched products (see the module docstring for the forms
    and modes): x (batch, n, n), y (batch, n, n), or (batch, n, c) for
    ``sum`` and ``single``. Returns the (batch, n, c) result.

    CUDA tensors launch the dot_chain kernel of ``csrc/probe_dots.cu``
    (counted in ``dot_chain.launches``), which replaces the Pallas kernels
    of scripts/probe_batched_dot.py:67 (P1), probe_dot_prec_speed.py:36
    (P2), probe_dot_prec_speed2.py:33 (P3), probe_mosaic_dot_prec.py:36 (P6)
    and probe_dotperf.py:55 (P8). It is bound by operations: 2 n^2 c per
    product at the mode's rate (FP32 67, TF32 495 TFLOP/s, 3xtf32 a third
    of that). CPU tensors run ``dot_chain_reference``.
    """
    if x.device.type == "cpu":
        return dot_chain_reference(x, y, form, mode, chain, scale, ndot)
    out = _launch_dot_chain(x, y, form, mode, chain, scale, ndot)
    dot_chain.launches += 1
    return out


dot_chain.launches = 0


def lane_dot_chain_reference(x, a, chain, scale=1.0):
    """The plain version of ``lane_dot_chain``: x <- scale * C with
    C[i, j, s] = sum_k x[i, k, s] a[k, j, s], in FP32 products."""
    if chain < 1:
        raise ValueError(f"chain must be >= 1, got {chain}")
    with matmul_tf32(False):
        for _ in range(chain):
            x = torch.einsum("iks,kjs->ijs", x, a) * scale
    return x


def _launch_lane_dot_chain(x, a, chain, scale):
    """Check the operands, then one launch of the lane_dot_chain kernel."""
    if chain < 1:
        raise ValueError(f"chain must be >= 1, got {chain}")
    if x.dim() != 3 or x.shape[0] != x.shape[1]:
        raise ValueError(f"x must be (n, n, s), got {tuple(x.shape)}")
    _check_tensors([("x", x, x.shape), ("a", a, x.shape)])
    n, s = x.shape[0], x.shape[2]
    lib = _lib()
    fn = lib.vsm_lane_dot_chain_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + \
        [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(x)
    work = torch.empty_like(x) if chain > 1 else out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), a.data_ptr(), out.data_ptr(), work.data_ptr(),
                n, s, chain, float(scale), stream)
    _raise_on(rc, lib, "lane_dot_chain")
    return out


def lane_dot_chain(x, a, chain, scale=1.0):
    """The spectral-axis-last chain: x, a (n, n, s) f32, x <- scale * C with
    C[i, j, s] = sum_k x[i, k, s] a[k, j, s], ``chain`` times. Returns the
    (n, n, s) result.

    CUDA tensors launch the lane_dot_chain kernel of ``csrc/probe_dots.cu``
    (counted in ``lane_dot_chain.launches``), which replaces the Pallas
    kernels of scripts/probe_vpu_dot.py:59 (P4) and probe_dotperf.py:82
    (P9). Bound by FP32 operations, 2 n^3 s per step; its operands stream
    from L2. CPU tensors run ``lane_dot_chain_reference``.
    """
    if x.device.type == "cpu":
        return lane_dot_chain_reference(x, a, chain, scale)
    out = _launch_lane_dot_chain(x, a, chain, scale)
    lane_dot_chain.launches += 1
    return out


lane_dot_chain.launches = 0
