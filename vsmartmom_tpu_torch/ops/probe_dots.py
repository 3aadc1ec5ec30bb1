"""Small batched products for the dot-precision probes, with their plain
versions.

``dot_chain`` runs a chain of batched products on row-major (batch, n, n)
operands in one of four forms and one of three dot modes; ``lane_dot_chain``
runs the spectral-axis-last (n, n, s) chain. CUDA tensors launch the
hand-written kernels of ``csrc/probe_dots.cu`` (counted in ``.launches``);
CPU tensors run the plain versions ``dot_chain_reference`` and
``lane_dot_chain_reference``, which repeat each mode's arithmetic in torch.
The probes of ``vsmartmom_tpu_torch/probes/`` drive them.

Launch plans. ``dot_chain_plan`` cuts the output across blocks so that each
block keeps its whole chain on chip: a row slab of x with all of y for
``right``, a column slab of acc with all of x for ``left``, (row slab,
column slab) tiles for ``sum`` and ``single``, the slabs sized so that a
small batch still fills the card and at n = 104 two slabs are in flight
per SM. fp32 runs on the CUDA cores (4 x 8 register tiles, A k-major);
tf32 and 3xtf32 run ``wgmma`` tiles of 64 rows per warpgroup and a column
slab of one of ``TILE_WIDTHS`` (``csrc/hopper_mma.cuh``).
``lane_dot_chain_plan`` picks how many neighbouring spectral points one
block stages; the chain then runs on chip and the result is written once.
The C side checks a plan and reports its launch (``launch_info``).

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
import dataclasses

import torch

FORMS = ("right", "left", "sum", "single")
MODES = ("fp32", "tf32", "3xtf32")
#: The JAX dot precisions of the TPU probes and the H100 mode of each.
MODE_OF_PRECISION = {"highest": "fp32", "float32": "fp32", "high": "3xtf32",
                     "default": "tf32", None: "tf32"}
#: Largest n the dot_chain kernels take (a block holds all of x or y).
KERNEL_MAX_N = 128
#: Largest n the lane kernel takes (two points' x, a and the step's output
#: in one block's shared memory).
LANE_MAX_N = 64
#: The TF32 kernels' depths: n padded up to the next of these
#: (``tf32_depth``); a column slab (wgmma width N) is 16 or the depth.
TILE_WIDTHS = (16, 32, 56, 64, 104, 128)
#: Dynamic shared memory a block may take on the H100 (bytes), and what one
#: block may take so that two stay resident (228 KB a SM, 1 KB reserved
#: per block).
SMEM_LIMIT = 232448
SMEM_PER_SM = 233472
SMEM_TWO_PER_SM = 115712
#: Streaming multiprocessors of an H100 SXM: a plan for a small batch aims
#: at two blocks for each.
SMS = 132
#: Largest fp32 column slab a thread tile plan takes (256 threads at most).
SIMT_MAX_COLS = 128

_FORM_CODE = {"right": 0, "left": 1, "sum": 2, "single": 3}
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


def _up(v, m):
    return -(-v // m) * m


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of a probe kernel: the plan's choices (``rows`` and
    ``cols`` of the output per block for dot_chain, ``points`` per block for
    the lane chain) and what follows from them."""
    rows: int
    cols: int
    grid: tuple
    threads: int
    smem: int        # dynamic shared memory, bytes
    points: int = 0

    @property
    def blocks(self):
        return self.grid[0] * self.grid[1] * self.grid[2]

    @property
    def resident_by_smem(self):
        """Blocks an SM holds by shared memory alone (228 KB, 1 KB reserved
        per block); registers and threads may allow fewer."""
        return SMEM_PER_SM // (self.smem + 1024)


def tf32_depth(n):
    """The TF32 kernels' depth at n: n padded to the next of TILE_WIDTHS
    (a template argument of the kernel, so its wgmmas unroll)."""
    return next((w for w in TILE_WIDTHS if w >= n), 0)


def _dot_launch(batch, n, c, form, mode, rows, cols):
    """The launch of plan (rows, cols), or None where it does not fit the
    operands, the kernels or shared memory (csrc/probe_dots.cu, dot_launch,
    the same rules)."""
    if rows < 1 or cols < 1:
        return None
    rslabs, cslabs = -(-n // rows), -(-c // cols)
    if (form == "right" and cslabs != 1) or (form == "left" and rslabs != 1):
        return None
    if mode == "fp32":
        ns = _up(n, 4)
        if rows % 4 or cols % 8:
            return None
        tiles = (rows // 4) * (cols // 8)
        threads = 256 if form == "single" and tiles <= 32 else \
            max(_up(tiles, 32), 128)
        if threads > 256:
            return None
        if form == "left":
            floats = ns * rows + 2 * n * cols
        elif form == "sum":
            floats = 2 * rows * ns + n * cols
        else:
            floats = n * cols + 2 * ns * rows
    else:
        kp = tf32_depth(n)
        copies = 2 if mode == "3xtf32" else 1
        a_copies = copies + (form == "sum")
        if (rows != 64 and (rows != 128 or kp < 104)) or cols not in (16, kp):
            return None
        if form == "right" and cols != kp:
            return None
        threads = 2 * rows
        floats = kp * (a_copies * rows + copies * cols)
    smem = 4 * floats
    if smem > SMEM_LIMIT:
        return None
    return Plan(rows, cols, (batch, rslabs, cslabs), threads, smem)


def dot_chain_plan(batch, n, c, form, mode):
    """The launch plan of ``dot_chain`` on (batch, n, n) and (batch, n, c)
    operands (c = n for the chain forms): output rows and columns per block,
    the grid, threads and shared memory. Raises ValueError for operands the
    kernels do not take.

    * fp32: thread tiles of 4 rows x 8 columns, at least 128 threads a
      block (the rest load and wait). A right chain (and sum,
      single) cuts the rows in two at n > 64 and keeps all columns; a left
      chain keeps all rows and cuts the columns in two at n > 64; sum cuts
      the columns into slabs of <= 104; single takes the right chain's rows
      and slabs of <= 128 columns where the batch gives 2 blocks per SM,
      else its rows and 16 columns, with eight warps that split the depth
      (a single product has no chain to keep in step).
    * tf32 / 3xtf32: 64 rows per warpgroup, depth ``tf32_depth(n)``,
      column slabs of the whole depth or 16. A right chain takes two
      warpgroups sharing y at n > 64 where they fit, else row slabs of 64;
      a left chain all rows (two warpgroups at n > 64), its slab the whole
      depth where it fits, else 16; sum and single row slabs of 64 and the
      slab that computes fewer columns, single 16 where the batch would
      give fewer than 2 blocks per SM.
    """
    _check_form(form, mode, 1, 1)
    if not 1 <= n <= KERNEL_MAX_N:
        raise ValueError(f"the kernel takes n <= {KERNEL_MAX_N}, got n={n}")
    if form in ("right", "left") and c != n:
        raise ValueError(f"the {form} chain needs c == n, got c={c}")
    cand = []   # (rows, cols) in order of preference
    if mode == "fp32":
        ms = _up(-(-n // 2), 4) if n > 64 else _up(n, 4)
        if form == "right":
            cand = [(ms, _up(n, 8))]
        elif form == "left":
            cand = [(_up(n, 4), _up(-(-n // 2), 8) if n > 64 else _up(n, 8))]
        elif form == "sum":
            m = -(-c // 104)
            cand = [(ms, _up(-(-c // m), 8))]
        else:
            cs = _up(-(-c // -(-c // SIMT_MAX_COLS)), 8)
            if batch * -(-n // ms) * -(-c // cs) >= 2 * SMS:
                cand = [(ms, cs)]
            else:
                cand = [(ms, 16)]
    else:
        kp = tf32_depth(n)
        slab = 16 if _up(c, 16) < _up(c, kp) else kp
        if form == "right":
            cand = [(128, kp)] if n > 64 else []
            cand.append((64, kp))
        elif form == "left":
            rows = 64 if n <= 64 else 128
            cand = [(rows, kp), (rows, 16)]
        else:
            if form == "single" and batch * -(-n // 64) * -(-c // slab) \
                    < 2 * SMS:
                slab = 16
            cand = [(64, slab), (64, 16)]
    for rows, cols in cand:
        plan = _dot_launch(batch, n, c, form, mode, rows, cols)
        if plan is not None:
            return plan
    raise ValueError(f"no {mode} {form} plan fits n={n}, c={c}")


def lane_dot_chain_plan(n, s):
    """The launch plan of ``lane_dot_chain`` on (n, n, s) operands: points
    per block P = 4 where such a block leaves room for a second one on an SM,
    else 2; one group of (n/4) x (n/8) threads per point (rounded to whole
    warps), x, a and the step's output of each point in shared memory."""
    if not 1 <= n <= LANE_MAX_N:
        raise ValueError(f"the lane kernel takes n <= {LANE_MAX_N}, got "
                         f"n={n}")
    group = _up((_up(n, 4) // 4) * (_up(n, 8) // 8), 32)
    per = 4 * (n * _up(n, 8) + 2 * _up(n, 4) ** 2)
    points = 4 if 4 * per <= SMEM_TWO_PER_SM and 4 * group <= 512 else 2
    return Plan(_up(n, 4), _up(n, 8), (-(-s // points), 1, 1),
                points * group, points * per, points)


def launch_info(kind, *args):
    """What the C side makes of a plan: (grid, threads, dynamic shared
    bytes, resident blocks per SM by
    cudaOccupancyMaxActiveBlocksPerMultiprocessor).
    ``kind`` "dot" takes (batch, n, c, form, mode, plan), "lane"
    (n, s, plan). Builds the library; on the card only."""
    lib = _lib()
    info = (ctypes.c_int * 6)()
    if kind == "dot":
        batch, n, c, form, mode, plan = args
        fn = lib.vsm_dot_chain_info
        fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
        rc = fn(batch, n, c, _FORM_CODE[form], _MODE_CODE[mode], plan.rows,
                plan.cols, info)
    else:
        n, s, plan = args
        fn = lib.vsm_lane_dot_chain_info
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        rc = fn(n, s, plan.points, info)
    fn.restype = ctypes.c_int
    _raise_on(rc, lib, f"{kind} launch info")
    return tuple(info[:3]), info[3], info[4], info[5]


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
    plan = dot_chain_plan(batch, n, c, form, mode)
    _check_tensors([("x", x, (batch, n, n)), ("y", y, (batch, n, c))])
    lib = _lib()
    fn = lib.vsm_dot_chain_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + \
        [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(y)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), batch, n, c,
                _FORM_CODE[form], _MODE_CODE[mode], chain, ndot,
                float(scale), plan.rows, plan.cols, stream)
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
    and probe_dotperf.py:55 (P8), on the plan of ``dot_chain_plan``. It is
    bound by operations: 2 n^2 c per product at the mode's rate (FP32 67,
    TF32 495 TFLOP/s, 3xtf32 a third of that). CPU tensors run
    ``dot_chain_reference``.
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
    n, s = x.shape[0], x.shape[2]
    plan = lane_dot_chain_plan(n, s)
    _check_tensors([("x", x, x.shape), ("a", a, x.shape)])
    lib = _lib()
    fn = lib.vsm_lane_dot_chain_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + \
        [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), a.data_ptr(), out.data_ptr(), n, s, chain,
                float(scale), plan.points, stream)
    _raise_on(rc, lib, "lane_dot_chain")
    return out


def lane_dot_chain(x, a, chain, scale=1.0):
    """The spectral-axis-last chain: x, a (n, n, s) f32, x <- scale * C with
    C[i, j, s] = sum_k x[i, k, s] a[k, j, s], ``chain`` times. Returns the
    (n, n, s) result.

    CUDA tensors launch the lane_dot_chain kernel of ``csrc/probe_dots.cu``
    (counted in ``lane_dot_chain.launches``), which replaces the Pallas
    kernels of scripts/probe_vpu_dot.py:59 (P4) and probe_dotperf.py:82
    (P9), for n <= ``LANE_MAX_N``. Bound by FP32 operations, 2 n^3 s per
    step; a block reads its points' x and a once, runs the whole chain in
    shared memory and writes once (``lane_dot_chain_plan``). CPU tensors run
    ``lane_dot_chain_reference``.
    """
    if x.device.type == "cpu":
        return lane_dot_chain_reference(x, a, chain, scale)
    out = _launch_lane_dot_chain(x, a, chain, scale)
    lane_dot_chain.launches += 1
    return out


lane_dot_chain.launches = 0
