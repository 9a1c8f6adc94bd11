"""W8A8 int8 3x3 convolution of the eval UNet (the JAX package's
``models/vdm/layers.py`` ``Int8Conv``): kernel Q (``csrc/int8_conv.cu``).

Dynamic symmetric quantization, as Int8Conv computes it:

- weights: ``wscale[o] = max(max |w[o]|, 1e-12) / 127`` per output
  channel, ``wq = clip(round(w / wscale), -127, 127)`` as int8;
- activations: ``xscale = max(max |x|, 1e-12) / 127`` over the whole
  tensor the convolution sees (``amax_reduce`` widens the maximum first:
  under sequence parallelism, to the clip's every frame), ``xq`` alike;
- output: ``float(int32 conv(xq, wq)) * (wscale * xscale) + bias`` in
  float32, cast to the weights' dtype (the port's compute dtype).

Rounding is half to even (``torch.round``, ``jnp.round``). The parameters
are a ``nn.Conv2d``'s, so checkpoints load unchanged. Padding is 1 and the
stride 1 or 2 (the UNet's ResBlock, Downsample and Upsample convolutions).

Eval only: under ``torch.is_grad_enabled()`` with an input that requires
grad the call raises (round() has no gradient; JAX would differentiate
through the scales alone).

``int8_conv2d`` launches the kernels on CUDA tensors and takes the plain
version (``int8_conv2d_reference``) on CPU tensors. The plain version
computes the integer products exactly: in float64 (every partial sum is
an integer below 2^53; float32 is not exact, the largest |sum| at the
UNet's widths is 127^2 x 9 x 2560 = 3.7e8 > 2^24).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Callable

import torch
import torch.nn.functional as F

from . import cuda_build

# kernel launches: "int8_absmax", "int8_quantize", "int8_weight_quant",
# "int8_conv" (the four kernels of one call), "int8_conv_reference" (the
# plain version, CPU tensors)
launches: collections.Counter = collections.Counter()

EPS = 1e-12
QMAX = 127.0
CHANNEL_TILE = 64       # the kernel's K slice: channels padded to it
TILE_PIXELS = 128       # output pixels a tile of the kernel: th x tw
TILE_WIDTHS = (128, 64, 32, 16, 8)
# elements of float64 im2col columns a chunk of the plain version holds
PLAIN_CHUNK = 1 << 27

AmaxReduce = Callable[[torch.Tensor], None]


def reset_launch_counts() -> None:
    launches.clear()


def check_eval(*tensors: torch.Tensor | None) -> None:
    """Raise when gradients would be recorded through the quantization."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            "int8 convolution (UNetConfig.quant_convs) is eval-only: "
            "round() has no gradient; call it under torch.no_grad()")


def out_size(n: int, stride: int) -> int:
    """The output length of a 3x3 convolution with padding 1."""
    return (n - 1) // stride + 1


def padded_channels(c: int) -> int:
    """The channels of the kernel's int8 input and weight rows: ``c``
    rounded up to its 64-byte K slice (zeros in the pad)."""
    return -(-c // CHANNEL_TILE) * CHANNEL_TILE


def conv_tiles(ho: int, wo: int) -> tuple[int, int]:
    """The kernel's tile rectangle (th, tw) for an ho x wo output: th x tw
    = 128 output pixels of one image, tw in ``TILE_WIDTHS``, the width that
    covers the image with the fewest tiles (the widest of equals). The
    UNet's latent levels 72x128, 36x64, 18x32 and 9x16 get 1 x 128, 2 x
    64, 4 x 32 and 8 x 16."""
    tw = min(TILE_WIDTHS,
             key=lambda w: -(-ho // (TILE_PIXELS // w)) * -(-wo // w))
    return TILE_PIXELS // tw, tw


# -- the plain version -------------------------------------------------------

def scale_of(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-12) / 127 in float32, a correctly rounded division on
    every device (CUDA divides by a Python scalar through its
    reciprocal, which is not)."""
    a = torch.clamp(amax.float(), min=EPS)
    return a / torch.full_like(a, QMAX)


def quantize_reference(t: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clip(round(t / scale), -127, 127) as int8 (``scale`` broadcasts)."""
    return torch.round(t.float() / scale).clamp_(-QMAX, QMAX).to(torch.int8)


def weight_scales_reference(weight: torch.Tensor) -> torch.Tensor:
    """[O] float32: the per-output-channel scales of [O, I, 3, 3]."""
    return scale_of(weight.float().abs().amax(dim=(1, 2, 3)))


def activation_scale_reference(x: torch.Tensor,
                               amax_reduce: AmaxReduce | None = None
                               ) -> torch.Tensor:
    """[1] float32: the per-tensor scale of ``x`` (after ``amax_reduce``)."""
    amax = x.float().abs().amax().reshape(1)
    if amax_reduce is not None:
        amax_reduce(amax)
    return scale_of(amax)


def int_products_reference(xq: torch.Tensor, wq: torch.Tensor,
                           stride: int) -> torch.Tensor:
    """int32 [N, O, Ho, Wo]: the 3x3 convolution (padding 1) of int8 xq
    [N, C, H, W] with int8 wq [O, C, 3, 3], exactly: im2col columns and a
    matrix product in float64, a chunk of the batch at a time."""
    N, C, H, W = xq.shape
    O = wq.shape[0]
    Ho, Wo = out_size(H, stride), out_size(W, stride)
    w2 = wq.reshape(O, C * 9).double()
    out = torch.empty((N, O, Ho * Wo), dtype=torch.int32, device=xq.device)
    chunk = max(1, PLAIN_CHUNK // max(1, C * 9 * Ho * Wo))
    for i in range(0, N, chunk):
        cols = F.unfold(xq[i:i + chunk].double(), 3, padding=1,
                        stride=stride)
        out[i:i + chunk] = torch.matmul(w2, cols).to(torch.int32)
    return out.reshape(N, O, Ho, Wo)


def int8_products_reference(x: torch.Tensor, weight: torch.Tensor,
                            stride: int = 1,
                            amax_reduce: AmaxReduce | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """(int32 products [N, O, Ho, Wo], xscale [1], wscale [O])."""
    xs = activation_scale_reference(x, amax_reduce)
    ws = weight_scales_reference(weight)
    xq = quantize_reference(x, xs)
    wq = quantize_reference(weight, ws[:, None, None, None])
    return int_products_reference(xq, wq, stride), xs, ws


def int8_conv2d_reference(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor | None, stride: int = 1,
                          amax_reduce: AmaxReduce | None = None
                          ) -> torch.Tensor:
    """Plain version of ``int8_conv2d``: float32 products * (wscale *
    xscale) + bias, then the weight's dtype."""
    check_eval(x, weight, bias)
    prod, xs, ws = int8_products_reference(x, weight, stride, amax_reduce)
    out = prod.float() * (ws * xs)[None, :, None, None]
    if bias is not None:
        out = out + bias.float()[None, :, None, None]
    out = out.to(weight.dtype)
    if _channels_last(x):
        out = out.contiguous(memory_format=torch.channels_last)
    return out


# -- the kernels -------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("int8_conv")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.sc_int8_absmax.argtypes = [P, L, I, P, P]
    lib.sc_int8_quantize.argtypes = [P, I, I, I, I, I, I, P, P, P, P]
    lib.sc_int8_weight_quant.argtypes = [P, I, I, I, I, P, P, P]
    lib.sc_int8_conv.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                                 I, I, P]
    for fn in (lib.sc_int8_absmax, lib.sc_int8_quantize,
               lib.sc_int8_weight_quant, lib.sc_int8_conv):
        fn.restype = ctypes.c_int
    lib.sc_error_string.argtypes = [ctypes.c_int]
    lib.sc_error_string.restype = ctypes.c_char_p
    return lib


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_OUT_KIND = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}


def _channels_last(x: torch.Tensor) -> bool:
    return (not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last))


def _dense(x: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """``x`` as NCHW-contiguous or channels-last memory, 16-byte aligned,
    and whether it is channels-last."""
    nhwc = _channels_last(x)
    if not (nhwc or x.is_contiguous()):
        x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone(memory_format=(torch.channels_last if nhwc
                                   else torch.contiguous_format))
    return x, nhwc


def _check(err: int, what: str, lib) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.sc_error_string(err).decode()} ({err})")


def _dtype_code(t: torch.Tensor, name: str) -> int:
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    return _DTYPES[t.dtype]


def _launch(x: torch.Tensor, weight: torch.Tensor,
            bias: torch.Tensor | None, stride: int,
            amax_reduce: AmaxReduce | None, out_dtype: torch.dtype
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The four kernels on CUDA tensors: (output [N, O, Ho, Wo] of
    ``out_dtype``, int32 for the raw products, xscale, wscale)."""
    if x.dim() != 4 or weight.dim() != 4 or \
            tuple(weight.shape[2:]) != (3, 3) or \
            weight.shape[1] != x.shape[1]:
        raise ValueError(f"a 3x3 convolution of [N, C, H, W] {tuple(x.shape)}"
                         f" with [O, C, 3, 3], got {tuple(weight.shape)}")
    if stride not in (1, 2):
        raise ValueError(f"stride 1 or 2, got {stride}")
    if not (x.is_cuda and weight.device == x.device):
        raise ValueError("x and weight must be CUDA tensors on one device")
    N, C, H, W = x.shape
    O = weight.shape[0]
    Ho, Wo = out_size(H, stride), out_size(W, stride)
    Cp = padded_channels(C)
    th, tw = conv_tiles(Ho, Wo)
    xd, wd = _dtype_code(x, "x"), _dtype_code(weight, "weight")
    dev = x.device
    with torch.cuda.device(dev):
        lib = _library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        x, nhwc = _dense(x)
        w = weight.contiguous()
        if bias is None:
            b = torch.zeros(O, dtype=torch.float32, device=dev)
        else:
            b = bias.float().contiguous()
        cuda_build.require(b, "bias", torch.float32, (O,), align=4)
        amax = torch.zeros(1, dtype=torch.float32, device=dev)
        _check(lib.sc_int8_absmax(x.data_ptr(), x.numel(), xd,
                                  amax.data_ptr(), stream), "int8_absmax",
               lib)
        launches["int8_absmax"] += 1
        if amax_reduce is not None:
            amax_reduce(amax)
        xq = torch.empty((N, H, W, Cp), dtype=torch.int8, device=dev)
        xscale = torch.empty(1, dtype=torch.float32, device=dev)
        _check(lib.sc_int8_quantize(x.data_ptr(), xd, int(nhwc), N, C, H * W,
                                    Cp, amax.data_ptr(), xq.data_ptr(),
                                    xscale.data_ptr(), stream),
               "int8_quantize", lib)
        launches["int8_quantize"] += 1
        wq = torch.empty((O, 9 * Cp), dtype=torch.int8, device=dev)
        wscale = torch.empty(O, dtype=torch.float32, device=dev)
        _check(lib.sc_int8_weight_quant(w.data_ptr(), wd, O, C, Cp,
                                        wq.data_ptr(), wscale.data_ptr(),
                                        stream), "int8_weight_quant", lib)
        launches["int8_weight_quant"] += 1
        fmt = torch.channels_last if nhwc else torch.contiguous_format
        out = torch.empty((N, O, Ho, Wo), dtype=out_dtype, device=dev,
                          memory_format=fmt)
        _check(lib.sc_int8_conv(xq.data_ptr(), wq.data_ptr(),
                                wscale.data_ptr(), xscale.data_ptr(),
                                b.data_ptr(), out.data_ptr(), N, H, W, Cp, O,
                                stride, th, tw, _OUT_KIND[out_dtype],
                                int(nhwc), stream), "int8_conv", lib)
        launches["int8_conv"] += 1
    return out, xscale, wscale


def int8_conv2d(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor | None, stride: int = 1,
                amax_reduce: AmaxReduce | None = None) -> torch.Tensor:
    """The W8A8 3x3 convolution (padding 1, ``stride`` 1 or 2) of x [N, C,
    H, W] (float32 or bf16; NCHW or channels-last memory, kept in the
    output) with a ``nn.Conv2d``'s ``weight`` [O, C, 3, 3] and ``bias``
    [O]: the kernels on CUDA tensors, the plain version on CPU tensors.
    Returns [N, O, Ho, Wo] in the weight's dtype."""
    check_eval(x, weight, bias)
    if x.device.type == "cpu":
        launches["int8_conv_reference"] += 1
        return int8_conv2d_reference(x, weight, bias, stride, amax_reduce)
    if weight.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"weight must be float32 or bfloat16, got "
                        f"{weight.dtype}")
    return _launch(x, weight, bias, stride, amax_reduce, weight.dtype)[0]


def int8_products(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
                  amax_reduce: AmaxReduce | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernels' int32 products [N, O, Ho, Wo] (the conv's raw
    epilogue), xscale [1] and wscale [O] on CUDA tensors: what
    ``int8_products_reference`` computes, for holding the kernels against
    it exactly."""
    check_eval(x, weight)
    return _launch(x, weight, None, stride, amax_reduce, torch.int32)
