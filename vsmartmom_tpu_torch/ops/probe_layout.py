"""The layout probe's sixteen cases (scripts/probe_mosaic_casts.py), with
their plain versions.

``layout_op(case, *inputs)`` writes what the probe's JAX lambda of that case
writes. CUDA tensors launch the hand-written kernel of
``csrc/probe_layout.cu`` (counted in ``layout_op.launches``); CPU tensors
run ``layout_op_reference``, the torch expression of the case.
"""

import ctypes
from typing import Callable, NamedTuple

import torch

from .probe_dots import _check_tensors, matmul_tf32

#: The probe's widths: B points, N streams.
B, N = 32, 24


class Case(NamedTuple):
    name: str                  # the probe's own label
    in_shapes: Callable        # (B, N) -> list of input shapes
    out_shape: Callable        # (B, N) -> output shape
    plain: Callable            # the torch expression


CASES = (
    Case("squeeze_lead [0]", lambda b, n: [(1, b, n)], lambda b, n: (b, n),
         lambda x: x[0]),
    Case("expand_trail [:,:,None]", lambda b, n: [(b, n)],
         lambda b, n: (b, n, n),
         lambda x: x[:, :, None] + torch.zeros(x.shape + x.shape[-1:],
                                               dtype=x.dtype,
                                               device=x.device)),
    Case("expand_mid [:,None,:]", lambda b, n: [(b, n)],
         lambda b, n: (b, n, n),
         lambda x: x[:, None, :] + torch.zeros(x.shape + x.shape[-1:],
                                               dtype=x.dtype,
                                               device=x.device)),
    Case("bcast_in_dim (0,2)", lambda b, n: [(b, n)], lambda b, n: (b, n, n),
         lambda x: x[:, None, :].expand(-1, x.shape[1], -1)),
    Case("bcast_in_dim (0,1)", lambda b, n: [(b, n)], lambda b, n: (b, n, n),
         lambda x: x[:, :, None].expand(-1, -1, x.shape[1])),
    Case("1d->3d [:,None,None]", lambda b, n: [(b,)], lambda b, n: (b, n, n),
         lambda x: x[:, None, None] + torch.zeros((x.shape[0], N, N),
                                                  dtype=x.dtype,
                                                  device=x.device)),
    Case("reshape merge lead", lambda b, n: [(b, n, n)],
         lambda b, n: (b * n, n), lambda x: x.reshape(-1, x.shape[-1])),
    Case("reshape split lead", lambda b, n: [(b, n, n)],
         lambda b, n: (b // 2, 2, n, n),
         lambda x: x.reshape(x.shape[0] // 2, 2, *x.shape[1:])),
    Case("concat axis=-1", lambda b, n: [(b, n, n)] * 2,
         lambda b, n: (b, n, 2 * n), lambda x, y: torch.cat([x, y], dim=2)),
    Case("concat axis=1", lambda b, n: [(b, n, n)] * 2,
         lambda b, n: (b, 2 * n, n), lambda x, y: torch.cat([x, y], dim=1)),
    Case("iota2d+eq", lambda b, n: [(b, n, n)], lambda b, n: (b, n, n),
         lambda x: x + torch.eye(x.shape[-1], dtype=x.dtype,
                                 device=x.device)),
    Case("slice minor x[:, :, :4]", lambda b, n: [(b, n, n)],
         lambda b, n: (b, n, 4), lambda x: x[:, :, :4]),
    Case("batched dot", lambda b, n: [(b, n, n)] * 2, lambda b, n: (b, n, n),
         lambda x, y: torch.einsum("bij,bjk->bik", x, y)),
    Case("outer via dot", lambda b, n: [(b, n)] * 2, lambda b, n: (b, n, n),
         lambda x, y: torch.einsum("bi,bj->bij", x, y)),
    Case("reduce minor keepdims", lambda b, n: [(b, n, n)],
         lambda b, n: (b, n, n),
         lambda x: x - torch.sum(x, dim=2, keepdim=True)),
    Case("transpose minor", lambda b, n: [(b, n, n)], lambda b, n: (b, n, n),
         lambda x: torch.swapaxes(x, 1, 2)),
)


def layout_op_reference(case, *inputs):
    """The plain version: the torch expression of case ``case``."""
    with matmul_tf32(False):
        return CASES[case].plain(*inputs).contiguous()


def _launch_layout(case, inputs):
    """Check the inputs, then one launch of the layout kernel."""
    if not 0 <= case < len(CASES):
        raise ValueError(f"case {case} not in 0..{len(CASES) - 1}")
    c = CASES[case]
    x = inputs[0]
    b = x.shape[1] if case == 0 else x.shape[0]   # squeeze: (1, B, N)
    width = x.shape[-1] if x.dim() > 1 else N     # the 1-D case: (B,)
    want = c.in_shapes(b, width)
    if len(inputs) != len(want):
        raise ValueError(f"case {c.name!r} takes {len(want)} inputs, got "
                         f"{len(inputs)}")
    _check_tensors([(f"input {i}", t, shape)
                    for i, (t, shape) in enumerate(zip(inputs, want))])
    dev = x.device
    from .cuda_build import load
    lib = load("probe_layout")
    fn = lib.vsm_layout_case_f32
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.vsm_layout_error_string.argtypes = [ctypes.c_int]
    lib.vsm_layout_error_string.restype = ctypes.c_char_p
    out = torch.empty(c.out_shape(b, width), dtype=torch.float32, device=dev)
    y = inputs[-1]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(case, x.data_ptr(), y.data_ptr(), out.data_ptr(), b, width,
                out.numel(), stream)
    if rc != 0:
        raise RuntimeError("layout_op launch failed: "
                           + lib.vsm_layout_error_string(rc).decode())
    return out


def layout_op(case, *inputs):
    """Case ``case`` (an index into ``CASES``) of the layout probe on its
    inputs, f32 tensors of the case's shapes for some (B, N) (the 1-D
    case's output width is the probe's N, as in its JAX lambda).

    CUDA tensors launch the kernel of ``csrc/probe_layout.cu`` (counted in
    ``layout_op.launches``), which replaces the Pallas kernels of
    scripts/probe_mosaic_casts.py:19; each case is launch-bound (a few KB
    in and out). CPU tensors run ``layout_op_reference``.
    """
    if inputs[0].device.type == "cpu":
        return layout_op_reference(case, *inputs)
    out = _launch_layout(case, inputs)
    layout_op.launches += 1
    return out


layout_op.launches = 0
