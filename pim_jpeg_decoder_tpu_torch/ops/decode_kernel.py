"""Device decode of MCU batches: dequantize -> IDCT -> (upsample + BT.601),
and the raster epilogue of the device-resident batch path.

PyTorch counterpart of ``pim_jpeg_decoder_tpu/ops/decode_kernel.py``.  Two
implementations of the same integer spec (``ops/specs.py``,
``ops/idct_math.py``):

- :func:`decode_mcus_reference`, plain PyTorch on int32 tensors.  It runs
  the shared ``idct_1d`` butterfly (full scale) and the reduced-IDCT
  matrices (scale 2/4/8) unchanged, so it is bit-identical to the NumPy
  oracle and to the Pallas kernels by construction (int32 tensor
  arithmetic wraps like theirs).
- the hand-written CUDA kernels in ``csrc/decode_kernel.cu`` for a card.

:func:`decode_mcus` picks by the tensors' device: CPU tensors take the
plain version, CUDA tensors the kernel (or the call raises; nothing falls
back).  Output layouts are the JAX package's: RGB ``[3, luma_slots, nn, M]``
(nn = (8/scale)^2) and YCbCr ``[g, 64, M]`` uint8, pixels COLUMN-major
inside each slot (index = px*n + py).

:func:`raster_epilogue` (``csrc/raster_epilogue.cu``) turns the RGB output
of a batch into ``[B, H, W, 3]``, with per-image crop offsets and the
``(x - mean) * inv_std`` normalisation in the same pass;
:func:`raster_epilogue_reference` is its plain version.
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pim_jpeg_decoder_tpu_torch.ops import specs as S
from pim_jpeg_decoder_tpu_torch.ops.idct_math import idct_1d

# Launch counters: each kernel's wrapper adds one where it launches, and
# "plain_on_cuda" counts plain-version calls on CUDA tensors (a run that
# claims to use the kernels must show 0 there).
_counts: Dict[str, int] = {"rgb": 0, "ycbcr": 0, "rgb_scaled": 0,
                           "raster": 0, "dequant": 0, "idct": 0, "color": 0,
                           "memfloor": 0, "truerez": 0, "stacked": 0,
                           "mxu2pass": 0, "mxu64": 0, "vlc": 0,
                           "plain_on_cuda": 0}
_counts_lock = threading.Lock()


def _count(name: str) -> None:
    with _counts_lock:
        _counts[name] += 1


def launch_counts() -> Dict[str, int]:
    with _counts_lock:
        return dict(_counts)


def reset_launch_counts() -> None:
    with _counts_lock:
        for k in _counts:
            _counts[k] = 0


# --- state carried to the device ---------------------------------------------

def coeffs_to_device(coeffs: np.ndarray, device) -> torch.Tensor:
    """``[M, g, 64]`` int16 or int8 coefficients -> tensor on ``device``."""
    if coeffs.dtype not in (np.int16, np.int8) or coeffs.ndim != 3:
        raise ValueError(f"coefficients must be [M, g, 64] int16/int8, got "
                         f"{coeffs.shape} {coeffs.dtype}")
    return torch.from_numpy(np.ascontiguousarray(coeffs)).to(device)


def qpool_to_device(qpool: np.ndarray, device) -> torch.Tensor:
    """``[Q, g, 64]`` float32 quantizer rows -> int32 tensor on ``device``.

    Exact: quantizer values are integers below 2^24.  Replaces the TPU
    kernel's one-hot MXU gather with a plain indexed load of
    ``qpool[qidx[m], s, k]``.
    """
    return torch.from_numpy(
        np.ascontiguousarray(qpool).astype(np.int32)).to(device)


# --- plain PyTorch version ---------------------------------------------------

def dequantized(coeffs: torch.Tensor, qidx: torch.Tensor,
                qpool: torch.Tensor) -> torch.Tensor:
    """``clip(coeffs * qpool[qidx[m]])`` to the int16 range, as int32
    ``[M, g, 64]``."""
    q = qpool[qidx.long()]                                   # [M, g, 64]
    return (coeffs.to(torch.int32) * q).clamp(-S.DEQUANT_CLAMP - 1,
                                               S.DEQUANT_CLAMP)


def idct_blocks(deq: torch.Tensor) -> torch.Tensor:
    """``[..., 8(v), 8(u)]`` int32 dequantized blocks -> ``[..., 8(px),
    8(py)]`` int32 samples clamped to the sample range (column-major, the
    kernels' pixel order)."""
    rows1 = idct_1d([deq[..., v, :] for v in range(8)],
                    S.CONST_BITS - S.PASS1_BITS)       # over py: [..., u]
    y = torch.stack(rows1, dim=-2)                     # [..., py, u]
    cols2 = idct_1d([y[..., u] for u in range(8)],
                    S.CONST_BITS + S.PASS1_BITS + 3)   # over px: [..., py]
    return torch.stack(cols2, dim=-2).clamp(S.SAMPLE_MIN, S.SAMPLE_MAX)


@functools.lru_cache(maxsize=None)
def _chroma_index(mode: S.ModeSpec) -> torch.Tensor:
    """``[luma_slots, 64]`` index into a column-major chroma block giving
    each luma-slot pixel its nearest-neighbour chroma sample."""
    rh, rw = 8 // mode.v, 8 // mode.h
    idx = torch.empty(mode.luma_slots, 64, dtype=torch.long)
    for s in range(mode.luma_slots):
        qv, qh = mode.luma_slot_pos(s)
        for px in range(8):
            for py in range(8):
                row = qv * rh + py // mode.v
                col = qh * rw + px // mode.h
                idx[s, px * 8 + py] = col * 8 + row
    return idx


def _reduced_pass(xs, mat, shift: int):
    """One n-point reduced-IDCT pass (JAX ``_reduced_pass``): ``xs`` is a
    frequency-indexed list of n tensors; returns the n transformed ones."""
    outs = []
    for row in mat:
        acc = xs[0] * row[0]
        for u in range(1, len(row)):
            acc = acc + xs[u] * row[u]
        outs.append(S.descale(acc, shift))
    return outs


def _reduced_idct(deq: torch.Tensor, ny: int, nx: int) -> torch.Tensor:
    """Reduced (ny x nx)-point IDCT of the top-left frequencies of
    ``[..., 8(v), 8(u)]`` int32 blocks -> ``[..., nx(px), ny(py)]`` int32
    samples, clamped (specs.py 'Reduced (scaled) IDCT'; the matrix form in
    both passes, also for 8 points)."""
    rows1 = _reduced_pass([deq[..., v, :nx] for v in range(ny)],
                          S.reduced_idct_matrix(ny),
                          S.CONST_BITS - S.PASS1_BITS)   # over py: [..., u]
    y = torch.stack(rows1, dim=-1)                       # [..., u, py]
    cols2 = _reduced_pass([y[..., u, :] for u in range(nx)],
                          S.reduced_idct_matrix(nx),
                          S.CONST_BITS + S.PASS1_BITS)   # over px: [..., py]
    return torch.stack(cols2, dim=-2).clamp(S.SAMPLE_MIN, S.SAMPLE_MAX)


def _scaled_samples(deq: torch.Tensor, mode: S.ModeSpec, n: int):
    """Scaled decode's samples: luma ``[M, gy, n*n]`` and, for colour
    modes, each slot's n x n region of the (v*n) x (h*n)-point chroma IDCT
    (no upsampling), ``[M, gy, n*n]`` for Cb and Cr."""
    m, gy = deq.shape[0], mode.luma_slots
    luma = _reduced_idct(deq[:, :gy], n, n).reshape(m, gy, n * n)
    if mode.ncomp == 1:
        return luma, None, None
    chroma = _reduced_idct(deq[:, gy:], mode.v * n, mode.h * n)
    regions = []
    for s in range(gy):
        qv, qh = mode.luma_slot_pos(s)
        regions.append(chroma[:, :, qh * n:(qh + 1) * n, qv * n:(qv + 1) * n]
                       .reshape(m, 2, n * n))
    cbcr = torch.stack(regions, dim=2)                       # [M, 2, gy, nn]
    return luma, cbcr[:, 0], cbcr[:, 1]


def decode_mcus_reference(coeffs: torch.Tensor, qidx: torch.Tensor,
                          qpool: torch.Tensor, mode: S.ModeSpec, *,
                          raw: bool = False, ycbcr: bool = False,
                          scale: int = 1) -> torch.Tensor:
    """Plain PyTorch decode of ``[M, g, 64]`` coefficients.

    ``qidx`` ``[M]`` int32 selects each MCU's row of the int32 quantizer
    pool ``qpool`` ``[Q, g, 64]``.  Returns ``[g, 64, M]`` level-shifted
    YCbCr with ``ycbcr=True`` (full scale only), RGB
    ``[3, luma_slots, nn, M]`` with ``raw=True``, else RGB
    ``[M, luma_slots, nn, 3]``, where nn = (8/scale)^2.  Calls on CUDA
    tensors are counted under ``plain_on_cuda``.
    """
    _check_scale(scale, ycbcr)
    if coeffs.device.type == "cuda":
        _count("plain_on_cuda")
    m = coeffs.shape[0]
    deq = dequantized(coeffs, qidx, qpool).view(m, mode.g, 8, 8)
    if scale != 1:
        luma, cb, cr = _scaled_samples(deq, mode, 8 // scale)
    else:
        spat = idct_blocks(deq).reshape(m, mode.g, 64)
        if ycbcr:
            return (spat + 128).to(torch.uint8).permute(1, 2, 0).contiguous()
        luma, cb, cr = upsampled_samples(spat, mode)
    return _rgb_layout(bt601_planes(luma, cb, cr), raw)


def upsampled_samples(spat: torch.Tensor, mode: S.ModeSpec):
    """Column-major int32 samples ``[M, g, 64]`` -> luma ``[M, gy, 64]``
    and, for colour modes, each luma pixel's nearest Cb and Cr sample
    (``[M, gy, 64]`` each; None for gray)."""
    gy = mode.luma_slots
    if mode.ncomp == 1:
        return spat[:, :gy], None, None
    idx = _chroma_index(mode).to(spat.device)
    return spat[:, :gy], spat[:, gy][:, idx], spat[:, gy + 1][:, idx]


def bt601_planes(luma: torch.Tensor, cb: Optional[torch.Tensor],
                 cr: Optional[torch.Tensor]) -> torch.Tensor:
    """Fixed-point BT.601 of int32 ``[M, gy, nn]`` samples (gray: cb = cr
    = None, the luma in all three planes) -> uint8 ``[3, gy, nn, M]``.
    int32 tensor arithmetic wraps like the spec's."""
    y128 = luma + 128
    if cb is None:
        planes = [y128] * 3
    else:
        planes = [
            y128 + S.descale(S.FIX_CR_R * cr, S.COLOR_BITS),
            y128 + S.descale(S.FIX_CB_G * cb + S.FIX_CR_G * cr,
                             S.COLOR_BITS),
            y128 + S.descale(S.FIX_CB_B * cb, S.COLOR_BITS),
        ]
    rgb = torch.stack([p.clamp(0, 255) for p in planes]).to(torch.uint8)
    return rgb.permute(0, 2, 3, 1).contiguous()


def _rgb_layout(raw_rgb: torch.Tensor, raw: bool) -> torch.Tensor:
    """``[3, gy, nn, M]`` -> itself, or the slot-major ``[M, gy, nn, 3]``
    (a real copy, as in the JAX package; the engine uses ``raw=True``)."""
    return raw_rgb if raw else raw_rgb.permute(3, 1, 2, 0).contiguous()


def _check_scale(scale: int, ycbcr: bool) -> None:
    if scale not in (1, 2, 4, 8):
        raise ValueError(f"scale must be 1, 2, 4 or 8, got {scale}")
    if ycbcr and scale != 1:
        raise ValueError("ycbcr transport is full-scale only")


# --- the CUDA kernels --------------------------------------------------------

def _check_inputs(coeffs, qidx, qpool, mode: S.ModeSpec) -> None:
    if coeffs.dtype not in (torch.int16, torch.int8):
        raise ValueError(f"coefficients must be int16 or int8, got "
                         f"{coeffs.dtype}")
    if coeffs.dim() != 3 or coeffs.shape[1:] != (mode.g, 64):
        raise ValueError(f"coefficients must be [M, {mode.g}, 64] for "
                         f"{mode.name}, got {tuple(coeffs.shape)}")
    if qidx.dtype != torch.int32 or qidx.shape != (coeffs.shape[0],):
        raise ValueError(f"qidx must be [{coeffs.shape[0]}] int32, got "
                         f"{tuple(qidx.shape)} {qidx.dtype}")
    if (qpool.dtype != torch.int32 or qpool.dim() != 3
            or qpool.shape[1:] != (mode.g, 64) or qpool.shape[0] < 1):
        raise ValueError(f"qpool must be [Q, {mode.g}, 64] int32 "
                         f"(see qpool_to_device), got "
                         f"{tuple(qpool.shape)} {qpool.dtype}")
    devices = {coeffs.device, qidx.device, qpool.device}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {devices}")
    for t in (coeffs, qidx, qpool):
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")


def _launch(coeffs, qidx, qpool, mode: S.ModeSpec, ycbcr: bool,
            scale: int):
    from pim_jpeg_decoder_tpu_torch.ops._build import load
    if coeffs.data_ptr() % 16 or qpool.data_ptr() % 16:
        raise ValueError("coefficients and qpool must be 16-byte aligned "
                         "(the kernel loads them 16 bytes at a time)")
    lib = load()
    m = coeffs.shape[0]
    args = ()
    if ycbcr:
        shape, fn, name = ((mode.g, 64, m), lib.pjt_cuda_decode_ycbcr,
                           "ycbcr")
    elif scale == 1:
        shape, fn, name = ((3, mode.luma_slots, 64, m),
                           lib.pjt_cuda_decode_rgb, "rgb")
    else:
        shape, fn, name = ((3, mode.luma_slots, (8 // scale) ** 2, m),
                           lib.pjt_cuda_decode_rgb_scaled, "rgb_scaled")
        args = (scale,)
    out = torch.empty(shape, dtype=torch.uint8, device=coeffs.device)
    if m == 0:
        return out
    with torch.cuda.device(coeffs.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(coeffs.data_ptr(), coeffs.element_size(), qidx.data_ptr(),
                qpool.data_ptr(), qpool.shape[0], out.data_ptr(), m,
                mode.h, mode.v, mode.ncomp, *args, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA decode kernel ({name}, {mode.name}, "
                           f"scale {scale}, M={m}) failed to launch: "
                           f"cudaError {rc}")
    _count(name)
    return out


def decode_mcus(coeffs: torch.Tensor, qidx: torch.Tensor,
                qpool: torch.Tensor, mode: S.ModeSpec, *, raw: bool = False,
                ycbcr: bool = False, scale: int = 1) -> torch.Tensor:
    """Decode a batch of MCUs on the tensors' device.

    Counterpart of ``pim_jpeg_decoder_tpu.ops.decode_kernel.decode_mcus``,
    with the same output layouts (see :func:`decode_mcus_reference`);
    ``scale`` 2/4/8 is the reduced-IDCT scaled decode.  Any M is
    accepted: the kernel masks the ragged end, so no lane-tile padding is
    needed.  ``qpool`` is the int32 pool from :func:`qpool_to_device`.
    """
    _check_scale(scale, ycbcr)
    _check_inputs(coeffs, qidx, qpool, mode)
    if coeffs.device.type == "cpu":
        return decode_mcus_reference(coeffs, qidx, qpool, mode, raw=raw,
                                     ycbcr=ycbcr, scale=scale)
    if coeffs.device.type != "cuda":
        raise ValueError(f"unsupported device {coeffs.device}")
    out = _launch(coeffs, qidx, qpool, mode, ycbcr, scale)
    return out if ycbcr else _rgb_layout(out, raw)


# --- the raster epilogue of the batch path -----------------------------------

# (output dtype, per-channel mean or None, per-channel 1/std or None), or
# None for raw uint8: see models.input_pipeline._norm_static.
Norm = Optional[Tuple[torch.dtype, Optional[tuple], Optional[tuple]]]

_OUT_KINDS = {None: 0, torch.float32: 1, torch.bfloat16: 2, torch.float16: 3}


def apply_norm(img: torch.Tensor, norm: Norm) -> torch.Tensor:
    """Plain uint8 -> normalised float: ``(x - mean) * inv_std`` computed
    in float32, cast to the requested dtype last (JAX ``_apply_norm``)."""
    if norm is None:
        return img
    dtype, mean3, inv_std3 = norm
    x = img.to(torch.float32)
    if mean3 is not None:
        x = x - torch.tensor(mean3, dtype=torch.float32, device=x.device)
    if inv_std3 is not None:
        x = x * torch.tensor(inv_std3, dtype=torch.float32, device=x.device)
    return x.to(dtype)


def _crop_origins(offsets: torch.Tensor, limit: int) -> torch.Tensor:
    """Crop origins clamped into ``[0, limit]``, as ``dynamic_slice``
    clamps its start indices."""
    return offsets.long().clamp(0, limit)


def raster_epilogue_reference(raw: torch.Tensor, mode: S.ModeSpec,
                              scale: int, batch: int, gh: int, gw: int,
                              out_h: int, out_w: int,
                              oys: Optional[torch.Tensor] = None,
                              oxs: Optional[torch.Tensor] = None,
                              norm: Norm = None) -> torch.Tensor:
    """Plain version of :func:`raster_epilogue`: the JAX package's
    ``_raster_relayout``, then the per-image crop (``oys``/``oxs``, or the
    top-left ``out_h x out_w`` without them), then ``_apply_norm``.
    Calls on CUDA tensors are counted under ``plain_on_cuda``."""
    if raw.device.type == "cuda":
        _count("plain_on_cuda")
    v, h, n = mode.v, mode.h, 8 // scale
    img = (raw[..., : batch * gh * gw]
           .reshape(3, v, h, n, n, batch, gh, gw)
           .permute(5, 6, 1, 4, 7, 2, 3, 0)
           .reshape(batch, gh * v * n, gw * h * n, 3))
    if oys is None:
        crops = img[:, :out_h, :out_w]
    else:
        dev = raw.device
        rows = (_crop_origins(oys, img.shape[1] - out_h)[:, None]
                + torch.arange(out_h, device=dev))
        cols = (_crop_origins(oxs, img.shape[2] - out_w)[:, None]
                + torch.arange(out_w, device=dev))
        crops = img[torch.arange(batch, device=dev)[:, None, None],
                    rows[:, :, None], cols[:, None, :]]
    return apply_norm(crops.contiguous(), norm)


def _check_epilogue(raw, mode: S.ModeSpec, scale: int, batch: int, gh: int,
                    gw: int, out_h: int, out_w: int, oys, oxs,
                    norm: Norm) -> None:
    n = 8 // scale if scale in (1, 2, 4, 8) else 0
    want = (3, mode.luma_slots, n * n)
    if (raw.dtype != torch.uint8 or raw.dim() != 4
            or tuple(raw.shape[:3]) != want or not raw.is_contiguous()):
        raise ValueError(f"raw must be contiguous uint8 [{want}, M] for "
                         f"{mode.name} at scale {scale}, got "
                         f"{tuple(raw.shape)} {raw.dtype}")
    if batch < 1 or batch * gh * gw > raw.shape[3]:
        raise ValueError(f"{batch} images of {gh}x{gw} MCUs do not fit in "
                         f"M={raw.shape[3]}")
    if not (0 < out_h <= gh * mode.v * n and 0 < out_w <= gw * mode.h * n):
        raise ValueError(f"output {out_h}x{out_w} outside the "
                         f"{gh * mode.v * n}x{gw * mode.h * n} grid")
    if (oys is None) != (oxs is None):
        raise ValueError("pass both crop offsets (oys, oxs) or neither")
    for t in (oys, oxs):
        if t is not None and (t.dtype != torch.int32 or t.shape != (batch,)
                              or t.device != raw.device
                              or not t.is_contiguous()):
            raise ValueError(f"crop offsets must be contiguous int32 "
                             f"[{batch}] on {raw.device}")
    if (norm[0] if norm else None) not in _OUT_KINDS:
        raise ValueError(f"output dtype must be float32, bfloat16 or "
                         f"float16, got {norm[0]}")


def raster_epilogue(raw: torch.Tensor, mode: S.ModeSpec, scale: int,
                    batch: int, gh: int, gw: int, out_h: int, out_w: int,
                    oys: Optional[torch.Tensor] = None,
                    oxs: Optional[torch.Tensor] = None,
                    norm: Norm = None) -> torch.Tensor:
    """Kernel RGB ``[3, gy, nn, M]`` of ``batch`` images (``gh x gw`` MCUs
    each, image b at MCU b*gh*gw) -> ``[batch, out_h, out_w, 3]``.

    ``oys``/``oxs`` (int32 ``[batch]``, same device) are per-image crop
    origins in output pixels; without them the top-left ``out_h x out_w``
    of each image is kept.  ``norm`` gives the output dtype and
    ``(x - mean) * inv_std`` (see :func:`apply_norm`); None keeps uint8.
    CPU tensors take :func:`raster_epilogue_reference`; CUDA tensors the
    kernel in ``csrc/raster_epilogue.cu``, or the call raises.
    """
    _check_epilogue(raw, mode, scale, batch, gh, gw, out_h, out_w, oys, oxs,
                    norm)
    if raw.device.type == "cpu":
        return raster_epilogue_reference(raw, mode, scale, batch, gh, gw,
                                         out_h, out_w, oys, oxs, norm)
    if raw.device.type != "cuda":
        raise ValueError(f"unsupported device {raw.device}")
    from pim_jpeg_decoder_tpu_torch.ops._build import load
    lib = load()
    dtype, mean3, inv3 = norm or (torch.uint8, None, None)
    out = torch.empty((batch, out_h, out_w, 3), dtype=dtype,
                      device=raw.device)
    with torch.cuda.device(raw.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pjt_cuda_raster_epilogue(
            raw.data_ptr(), raw.shape[3], mode.v, mode.h, 8 // scale, batch,
            gh, gw, out_h, out_w,
            None if oys is None else oys.data_ptr(),
            None if oxs is None else oxs.data_ptr(),
            _OUT_KINDS[norm[0] if norm else None],
            *(float(np.float32(c)) for c in mean3 or (0.0,) * 3),
            *(float(np.float32(c)) for c in inv3 or (1.0,) * 3),
            out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"CUDA raster epilogue ({mode.name}, scale "
                           f"{scale}, {batch}x{out_h}x{out_w}, {dtype}) "
                           f"failed to launch: cudaError {rc}")
    _count("raster")
    return out

