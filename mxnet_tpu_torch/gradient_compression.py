"""2-bit gradient compression with error-feedback residuals.

The PyTorch counterpart of ``mxnet_tpu/gradient_compression.py``
(reference: src/kvstore/gradient_compression.{h,cc}, the
quantize_2bit/dequantize_2bit kernels of gradient_compression-inl.h).
The residual accumulates each gradient; where it reaches +threshold the
code is 3 (the value sent is +threshold), where it reaches -threshold
the code is 2 (-threshold), else 0; the sent value leaves the residual.
Sixteen codes are packed into a 32-bit word as the reference and the
JAX package pack them: value i sits in byte i // 4, the leading two
bits first (shift ``8 * (i // 4) + 6 - 2 * (i % 4)``).

torch's ``uint32`` has few operations, so the packed words are held as
``int32`` tensors with the same bits (``.numpy().view("uint32")`` gives
the JAX package's words). Both functions run on a tensor of either
device, in torch operations.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["GradientCompression", "quantize_2bit", "dequantize_2bit"]

_SHIFTS = [8 * (i // 4) + 6 - 2 * (i % 4) for i in range(16)]


def _shifts(device):
    return torch.tensor(_SHIFTS, dtype=torch.int64, device=device)


def quantize_2bit(grad, residual, threshold):
    """(packed words as int32, new residual) for flat float32 ``grad``
    and ``residual``."""
    r = residual + grad
    pos = r >= threshold
    neg = r <= -threshold
    codes = torch.where(pos, 3, torch.where(neg, 2, 0)).to(torch.int64)
    new_res = r - threshold * pos.to(r.dtype) + threshold * neg.to(r.dtype)
    n = grad.shape[0]
    nwords = -(-n // 16)
    codes = torch.nn.functional.pad(codes, (0, nwords * 16 - n))
    words = (codes.view(nwords, 16) << _shifts(grad.device)).sum(dim=-1)
    # the uint32 bits as an int32 (two's complement)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32), new_res


def dequantize_2bit(packed, n, threshold):
    """The +threshold/0/-threshold float32 values of ``n`` codes."""
    words = packed.to(torch.int64) & 0xFFFFFFFF
    codes = (words[:, None] >> _shifts(packed.device)) & 3
    one = torch.ones((), dtype=torch.float32, device=packed.device)
    vals = torch.where(codes == 3, threshold * one,
                       torch.where(codes == 2, -threshold * one, 0 * one))
    return vals.reshape(-1)[:n]


class GradientCompression:
    """Reference: GradientCompression (gradient_compression.h:36).

    ``quantize`` takes a gradient and that source's residual and returns
    the packed words (16 times smaller) and the new residual;
    ``dequantize`` rebuilds the +threshold/0/-threshold gradient."""

    def __init__(self, type="2bit", threshold=0.5):
        if type != "2bit":
            raise MXNetError(
                f"unsupported compression type '{type}' (reference "
                "supports 2bit, gradient_compression.cc:61)")
        if threshold <= 0:
            raise MXNetError("threshold must be positive")
        self.type = type
        self.threshold = float(threshold)

    def get_compression_factor(self):
        return 16  # float32 -> 2 bits

    def compressed_size(self, original_size):
        return -(-original_size // self.get_compression_factor())

    def _th(self, like):
        # the threshold as a float32 scalar, so the arithmetic rounds as
        # the JAX package's jnp.float32 threshold does
        return torch.tensor(self.threshold, dtype=torch.float32,
                            device=like.device)

    def quantize(self, grad, residual):
        """grad: flat float32 tensor; residual: the same shape. Returns
        (packed int32 words, new residual)."""
        with torch.no_grad():
            return quantize_2bit(grad, residual, self._th(grad))

    def dequantize(self, packed, size):
        with torch.no_grad():
            return dequantize_2bit(packed, size, self._th(packed))

    def roundtrip(self, grad, residual):
        """``grad`` (a tensor of any shape) through the wire format and
        back: (the values a receiver sums, in ``grad``'s shape and dtype,
        the new flat float32 residual; None starts from zeros)."""
        flat = grad.detach().reshape(-1).to(torch.float32)
        if residual is None:
            residual = torch.zeros_like(flat)
        packed, new_res = self.quantize(flat, residual)
        deq = self.dequantize(packed, flat.shape[0])
        return deq.reshape(grad.shape).to(grad.dtype), new_res

    def params(self):
        return {"type": self.type, "threshold": self.threshold}
