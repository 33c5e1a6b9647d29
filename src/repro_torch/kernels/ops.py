"""Wrappers of the port's CUDA kernels (port of the matching wrappers in
``repro/kernels/ops.py``): the gradient-sync staging kernels
(``csrc/grad_sync.cu``) and flash attention (``csrc/flash_attention.cu``).

Each wrapper checks device, dtype, shape and contiguity, then:
* on CPU tensors, returns its plain PyTorch version from :mod:`.ref`;
* on CUDA tensors, launches its CUDA kernel on the current stream, or
  raises.  There is no fallback and no switch: the tensors' device decides.

Each wrapper counts its kernel launches in a plain integer attribute
(``fused_pack.launches``), incremented only where the kernel launches.

The layout arithmetic around the kernels — chunk cuts, dp padding, and the
segment tables that map leaves onto the staged buffer — is plain Python
here (:func:`pack_segments`, :func:`unpack_segments`), so the CPU tests
reach it even though the kernels themselves only run on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import ref as _ref
from .ref import chunk_cuts

_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ZERO = -1
TILE_ELEMS = 8192   # elements per tile of a segmented launch (mult. of 8)


def _check_dtype(t: torch.Tensor, what: str) -> None:
    if t.dtype not in _CODES:
        raise TypeError(f"{what}: dtype {t.dtype} is not f32, bf16 or f16")


def _on_cuda(tensors, what: str) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie
    on the CPU; raises on anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{what}: tensors lie on several devices "
                         f"{sorted(map(str, devices))}")
    dev = next(iter(devices))
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    return True


def _check_contiguous(tensors, what: str) -> None:
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what}: the CUDA kernel needs contiguous "
                             f"tensors")


def _raise_on_error(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA kernel launch failed: {msg} ({rc})")


def _aligned(*ptrs: int) -> bool:
    return all(p % 16 == 0 for p in ptrs)


# ------------------------------------------------------------ convert-copy
def convert_copy(x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """A copy of ``x`` converted to ``out_dtype`` (f32, bf16 or f16; round
    to nearest even), of the same shape."""
    from .build import load_library

    _check_dtype(x, "convert_copy")
    if out_dtype not in _CODES:
        raise TypeError(f"convert_copy: out dtype {out_dtype} is not f32, "
                        f"bf16 or f16")
    if not _on_cuda([x], "convert_copy"):
        return _ref.convert_copy_ref(x, out_dtype)
    _check_contiguous([x], "convert_copy")
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    n = x.numel()
    if n == 0:
        return out
    lib = load_library()
    with torch.cuda.device(x.device):
        rc = lib.repro_convert_copy(
            x.data_ptr(), _CODES[x.dtype], out.data_ptr(), _CODES[out_dtype],
            n, int(_aligned(x.data_ptr(), out.data_ptr())),
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on_error(lib, rc, "convert_copy")
    convert_copy.launches += 1
    return out


convert_copy.launches = 0


# ------------------------------------------------------- segment layouts
def staged_lengths(total: int, dp: int, chunks: int) -> list[int]:
    """Length of each chunk of the staged buffer: chunk ``c`` of
    :func:`chunk_cuts` zero-padded to a multiple of ``dp``."""
    cuts = chunk_cuts(total, chunks)
    dp = max(int(dp), 1)
    return [-(-(cuts[c + 1] - cuts[c]) // dp) * dp
            for c in range(len(cuts) - 1)]


def pack_segments(sizes: list[int], total: int, dp: int,
                  chunks: int) -> list[tuple[int, int, int, int]]:
    """The pack's copy plan: ``(leaf, leaf_offset, staged_offset, n)`` per
    run, with ``leaf == -1`` for a run of zeros.  The runs tile the staged
    buffer (the chunks of :func:`staged_lengths` back to back) exactly."""
    cuts = chunk_cuts(total, chunks)
    used = sum(sizes)
    starts = [sum(sizes[:i]) for i in range(len(sizes))]
    segs = []
    base = 0
    for c, padded in enumerate(staged_lengths(total, dp, chunks)):
        lo, hi = cuts[c], cuts[c + 1]
        for i, (o, n) in enumerate(zip(starts, sizes)):
            a, b = max(lo, o), min(hi, o + n)
            if a < b:
                segs.append((i, a - o, base + a - lo, b - a))
        zlo = min(max(lo, used), hi) - lo   # first chunk offset past the data
        if zlo < padded:
            segs.append((_ZERO, 0, base + zlo, padded - zlo))
        base += padded
    return segs


def unpack_segments(sizes: list[int],
                    chunks: int) -> list[tuple[int, int, int, int, int]]:
    """The unpack's copy plan: ``(leaf, leaf_offset, chunk, chunk_offset,
    n)`` per run, for chunks cut at :func:`chunk_cuts` of ``sum(sizes)``."""
    total = sum(sizes)
    cuts = chunk_cuts(total, chunks)
    segs = []
    o = 0
    for i, n in enumerate(sizes):
        for c in range(len(cuts) - 1):
            a, b = max(cuts[c], o), min(cuts[c + 1], o + n)
            if a < b:
                segs.append((i, a - o, c, a - cuts[c], b - a))
        o += n
    return segs


def _launch_segments(fn_name: str, rows: list, device) -> None:
    """Launch a segmented kernel over ``rows`` of (src_ptr, src_code,
    dst_ptr, dst_code, n): the segment table the kernel reads, one tile
    range per row."""
    from .build import load_library

    table, tile0 = [], 0
    for src, scode, dst, dcode, n in rows:
        vec = int(_aligned(dst) and (src == 0 or _aligned(src)))
        table.append([src, dst, n, tile0, scode, dcode, vec, 0])
        tile0 += -(-n // TILE_ELEMS)
    # pinned, so the copy is asynchronous and never stalls the stream
    dev_table = torch.tensor(table, dtype=torch.int64).pin_memory().to(
        device, non_blocking=True)
    lib = load_library()
    with torch.cuda.device(device):
        rc = getattr(lib, fn_name)(
            dev_table.data_ptr(), len(table), tile0, TILE_ELEMS,
            torch.cuda.current_stream(device).cuda_stream)
    _raise_on_error(lib, rc, fn_name)


# -------------------------------------------------------------- fused pack
def fused_pack(leaves: list, total: int, dp: int, chunks: int = 1) -> list:
    """Stage a bucket of gradient leaves into reduce-scatter-ready f32
    chunks: cast up, concatenate, zero-pad to ``total``, cut at
    :func:`chunk_cuts`, pad each chunk to a multiple of ``dp``.  On the
    card the chunks are views of one staging buffer, written by one
    launch."""
    if not leaves:
        raise ValueError("fused_pack: empty bucket")
    for l in leaves:
        _check_dtype(l, "fused_pack")
    sizes = [l.numel() for l in leaves]
    if total < sum(sizes):
        raise ValueError(f"fused_pack: total {total} < {sum(sizes)} "
                         f"elements in the bucket")
    if dp < 1 or chunks < 1:
        raise ValueError("fused_pack: dp and chunks must be >= 1")
    if not _on_cuda(leaves, "fused_pack"):
        return _ref.fused_pack_ref(leaves, total, dp, chunks)
    _check_contiguous(leaves, "fused_pack")
    device = leaves[0].device
    lens = staged_lengths(total, dp, chunks)
    buf = torch.empty(sum(lens), dtype=torch.float32, device=device)
    rows = []
    for leaf, loff, soff, n in pack_segments(sizes, total, dp, chunks):
        dst = buf.data_ptr() + 4 * soff
        if leaf == _ZERO:
            rows.append((0, _ZERO, dst, 0, n))
        else:
            l = leaves[leaf]
            rows.append((l.data_ptr() + l.element_size() * loff,
                         _CODES[l.dtype], dst, 0, n))
    if rows:
        _launch_segments("repro_fused_pack", rows, device)
        fused_pack.launches += 1
    offs = [sum(lens[:c]) for c in range(len(lens))]
    return [buf[o:o + n] for o, n in zip(offs, lens)]


fused_pack.launches = 0


# ------------------------------------------------------------ fused unpack
def fused_unpack(parts: list, shapes, dtypes,
                 out: list | None = None) -> list:
    """Unstage a gathered f32 bucket into leaves of ``shapes`` and
    ``dtypes`` (f32 -> grad dtype, round to nearest even).  ``parts`` is
    the list of the bucket's chunks as :func:`fused_pack` laid them out
    (chunk ``c`` cut at :func:`chunk_cuts` of the leaves' total, any
    padding after its data ignored); ``[flat]`` is the unchunked bucket.
    With ``out``, the leaves are written into those tensors, in place, and
    returned."""
    parts = list(parts)
    sizes = [math.prod(s) for s in shapes]
    total = sum(sizes)
    cuts = chunk_cuts(total, len(parts))
    for c, p in enumerate(parts):
        if p.dtype != torch.float32 or p.dim() != 1:
            raise TypeError("fused_unpack: chunks must be 1-D f32")
        if p.numel() < cuts[c + 1] - cuts[c]:
            raise ValueError(f"fused_unpack: chunk {c} holds {p.numel()} "
                             f"elements, needs {cuts[c + 1] - cuts[c]}")
    if out is not None:
        if len(out) != len(shapes):
            raise ValueError("fused_unpack: out has the wrong leaf count")
        for o, s, dt in zip(out, shapes, dtypes):
            if tuple(o.shape) != tuple(s) or o.dtype != dt:
                raise ValueError(f"fused_unpack: out leaf {tuple(o.shape)} "
                                 f"{o.dtype} != {tuple(s)} {dt}")
    for dt in dtypes:
        if dt not in _CODES:
            raise TypeError(f"fused_unpack: dtype {dt} is not f32, bf16 or "
                            f"f16")
    if not _on_cuda(parts + (out or []), "fused_unpack"):
        flat = torch.cat([p[:cuts[c + 1] - cuts[c]]
                          for c, p in enumerate(parts)])
        res = _ref.fused_unpack_ref(flat, shapes, dtypes)
        if out is None:
            return res
        for o, r in zip(out, res):
            o.copy_(r)
        return out
    _check_contiguous(parts + (out or []), "fused_unpack")
    device = parts[0].device
    if out is None:
        out = [torch.empty(tuple(s), dtype=dt, device=device)
               for s, dt in zip(shapes, dtypes)]
    rows = []
    for leaf, loff, c, coff, n in unpack_segments(sizes, len(parts)):
        o = out[leaf]
        rows.append((parts[c].data_ptr() + 4 * coff, _CODES[torch.float32],
                     o.data_ptr() + o.element_size() * loff, _CODES[o.dtype],
                     n))
    if rows:
        _launch_segments("repro_fused_unpack", rows, device)
        fused_unpack.launches += 1
    return out


fused_unpack.launches = 0


# --------------------------------------------------------- flash attention
FLASH_HEAD_DIMS = (32, 64, 128)
_FLASH_MAX_THREADS = 256    # kMaxThreads of csrc/flash_attention.cu


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Forward GQA attention.  q: (B,S,H,hd); k, v: (B,T,KV,hd), one dtype
    (f32, bf16 or f16), hd in :data:`FLASH_HEAD_DIMS`, H % KV == 0; any S
    and T.  Causal and window masks count positions from 0, as
    :func:`.ref.flash_attention_ref` does.  Forward only: on the card it
    raises when autograd would need its gradient."""
    from .build import load_library

    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k and v must be 4-D")
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, T, KV, hd) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"flash_attention: {H} query heads are not a "
                         f"multiple of {KV} KV heads")
    if hd not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} is not one of "
                         f"{FLASH_HEAD_DIMS}")
    if hd // 16 * (H // KV) > _FLASH_MAX_THREADS:
        raise ValueError(f"flash_attention: {H // KV} query heads per KV "
                         f"head at head dim {hd} exceed one block")
    for t in (q, k, v):
        _check_dtype(t, "flash_attention")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share one dtype")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if not _on_cuda([q, k, v], "flash_attention"):
        return _ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window)
    _check_contiguous([q, k, v], "flash_attention")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention: the CUDA kernel is forward "
                           "only; call it under torch.no_grad()")
    out = torch.empty_like(q)
    lib = load_library()
    with torch.cuda.device(q.device):
        rc = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _CODES[q.dtype], B, S, T, H, KV, hd, int(causal), window or 0,
            int(_aligned(k.data_ptr(), v.data_ptr())),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error(lib, rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def reset_launches() -> None:
    for fn in (convert_copy, fused_pack, fused_unpack, flash_attention):
        fn.launches = 0
