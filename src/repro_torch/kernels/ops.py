"""Wrappers of the port's CUDA kernels (port of the matching wrappers in
``repro/kernels/ops.py``): the gradient-sync staging kernels
(``csrc/grad_sync.cu``), flash attention and its backward
(``csrc/flash_attention.cu``),
the RG-LRU scan (``csrc/rglru.cu``) and the WKV-6 recurrence
(``csrc/wkv6.cu``).

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


def _pack_rows(leaves: list, buf: torch.Tensor, segs) -> list:
    """The kernel rows of a pack plan ``segs`` (:func:`pack_segments`)
    writing ``leaves`` into ``buf``, converted to its dtype."""
    esize, dcode = buf.element_size(), _CODES[buf.dtype]
    rows = []
    for leaf, loff, soff, n in segs:
        dst = buf.data_ptr() + esize * soff
        if leaf == _ZERO:
            rows.append((0, _ZERO, dst, dcode, n))
        else:
            l = leaves[leaf]
            rows.append((l.data_ptr() + l.element_size() * loff,
                         _CODES[l.dtype], dst, dcode, n))
    return rows


# ------------------------------------------------------------- bucket pack
def bucket_pack(leaves: list, total: int,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Stage an unfused bucket's leaves into one flat ``out_dtype`` buffer:
    each leaf converted (round to nearest even), concatenated and
    zero-padded to ``total``.  On the card one launch writes the whole
    bucket, from the segment table of :func:`pack_segments` at dp=1 and
    one chunk."""
    if not leaves:
        raise ValueError("bucket_pack: empty bucket")
    for l in leaves:
        _check_dtype(l, "bucket_pack")
    if out_dtype not in _CODES:
        raise TypeError(f"bucket_pack: out dtype {out_dtype} is not f32, "
                        f"bf16 or f16")
    sizes = [l.numel() for l in leaves]
    if total < sum(sizes):
        raise ValueError(f"bucket_pack: total {total} < {sum(sizes)} "
                         f"elements in the bucket")
    if not _on_cuda(leaves, "bucket_pack"):
        return _ref.bucket_pack_ref(leaves, total, out_dtype)
    _check_contiguous(leaves, "bucket_pack")
    device = leaves[0].device
    buf = torch.empty(total, dtype=out_dtype, device=device)
    rows = _pack_rows(leaves, buf, pack_segments(sizes, total, 1, 1))
    if rows:
        _launch_segments("repro_bucket_pack", rows, device)
        bucket_pack.launches += 1
    return buf


bucket_pack.launches = 0


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
    rows = _pack_rows(leaves, buf, pack_segments(sizes, total, dp, chunks))
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
FLASH_HEAD_DIMS = (32, 64, 128, 256)
FLASH_BWD_HEAD_DIMS = (128,)   # the backward kernel's (csrc BwdTile)
_FLASH_MAX_THREADS = 256    # kMaxThreads of csrc/flash_attention.cu
_LSE_ROWS = 64              # kBwdRows of csrc/flash_attention.cu


def _check_flash(q, k, v, window) -> None:
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
    for t in (q, k, v):
        _check_dtype(t, "flash_attention")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share one dtype")
    if (q.dtype == torch.float32
            and hd // 16 * (H // KV) > _FLASH_MAX_THREADS):
        raise ValueError(f"flash_attention: {H // KV} query heads per KV "
                         f"head at head dim {hd} exceed one block of the "
                         f"f32 kernel")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and starting on a 16-byte boundary, which TMA
    needs: ``t`` itself when it already is, else a fresh copy."""
    t = t.contiguous()
    return t if _aligned(t.data_ptr()) else t.clone()


def _flash_forward(q, k, v, causal, window, with_lse: bool):
    """One launch of the forward kernel on checked CUDA tensors; returns
    ``(out, lse)``, lse (B,H,S) f32 a view of a buffer padded to whole
    tiles of :data:`_LSE_ROWS` rows when ``with_lse`` (tensor cores only),
    else None."""
    from .build import load_library

    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    tensor_cores = q.dtype != torch.float32
    out = torch.empty_like(q)
    lse = None
    if with_lse:
        rows = -(-S // _LSE_ROWS) * _LSE_ROWS
        lse = torch.empty((B, H, rows), dtype=torch.float32, device=q.device)
    lib = load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if tensor_cores:
            q, k, v = (_tma_ready(t) for t in (q, k, v))
            rc = lib.repro_flash_attention_tc(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if with_lse else None,
                lse.shape[2] if with_lse else 0, _CODES[q.dtype], B, S, T, H,
                KV, hd, int(causal), window or 0, stream)
        else:
            rc = lib.repro_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _CODES[q.dtype], B, S, T, H, KV, hd, int(causal),
                window or 0, int(_aligned(k.data_ptr(), v.data_ptr())),
                stream)
    _raise_on_error(lib, rc, "flash_attention")
    flash_attention.launches += 1
    if tensor_cores:
        flash_attention.tc_launches += 1
    else:
        flash_attention.cuda_core_launches += 1
    if with_lse:
        flash_attention.lse_launches += 1
        lse = lse[:, :, :S]
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """The tensor-core kernel with its backward kernel as the gradient:
    the forward saves q, k, v, the output and the log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = _flash_forward(q, k, v, causal, window, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """GQA attention.  q: (B,S,H,hd); k, v: (B,T,KV,hd), one dtype (f32,
    bf16 or f16), hd in :data:`FLASH_HEAD_DIMS`, H % KV == 0; any S and T.
    Causal and window masks count positions from 0, as
    :func:`.ref.flash_attention_ref` does.

    On the card the dtype picks the kernel: bf16 and f16 run on the tensor
    cores (``repro_flash_attention_tc``, counted in ``.tc_launches``),
    f32 on the CUDA cores (``repro_flash_attention``, counted in
    ``.cuda_core_launches``; it takes at most 256 // (hd // 16) query heads
    per KV head).  ``.launches`` counts both.  The tensor-core kernel reads
    q, k and v with TMA, which needs 16-byte-aligned bases: a q, k or v
    that starts off a 16-byte boundary is first copied into a fresh
    tensor.  When autograd needs a gradient, bf16 and f16 at a head dim of
    :data:`FLASH_BWD_HEAD_DIMS` are differentiable: the forward also saves
    each row's log-sum-exp (counted in ``.lse_launches``) and the gradient
    is :func:`flash_attention_bwd` (counted in ``.bwd_launches``); any
    other case is forward only and raises."""
    _check_flash(q, k, v, window)
    if not _on_cuda([q, k, v], "flash_attention"):
        return _ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window)
    _check_contiguous([q, k, v], "flash_attention")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if q.dtype == torch.float32 or q.shape[3] not in FLASH_BWD_HEAD_DIMS:
            raise RuntimeError(
                f"flash_attention: the CUDA kernel has a backward for bf16 "
                f"and f16 at head dims {FLASH_BWD_HEAD_DIMS} only, not "
                f"{q.dtype} at {q.shape[3]}; call it under torch.no_grad()")
        return _FlashAttention.apply(q, k, v, causal, window)
    return _flash_forward(q, k, v, causal, window, with_lse=False)[0]


flash_attention.launches = 0
flash_attention.tc_launches = 0
flash_attention.cuda_core_launches = 0
flash_attention.lse_launches = 0
flash_attention.bwd_launches = 0


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None):
    """The forward of :func:`flash_attention` with each row's log-sum-exp
    of the masked scaled scores (natural log): ``(out, lse)``, lse (B,H,S)
    f32.  bf16 or f16 at a head dim of :data:`FLASH_BWD_HEAD_DIMS` on the
    card (one launch of the tensor-core kernel's instance that stores the
    log-sum-exp, counted in ``flash_attention.lse_launches`` too); on the
    CPU
    :func:`.ref.flash_attention_ref`.  Records no gradient."""
    _check_flash(q, k, v, window)
    if not _on_cuda([q, k, v], "flash_attention_lse"):
        out, lse = _ref.flash_attention_ref(q, k, v, causal=causal,
                                            window=window, return_lse=True)
        return out, lse.float()
    _check_contiguous([q, k, v], "flash_attention_lse")
    if q.dtype == torch.float32:
        raise TypeError("flash_attention_lse: the kernel saves the "
                        "log-sum-exp in bf16 and f16 only")
    if q.shape[3] not in FLASH_BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention_lse: the kernel saves the "
                         f"log-sum-exp at head dims {FLASH_BWD_HEAD_DIMS} "
                         f"only, not {q.shape[3]}")
    with torch.no_grad():
        return _flash_forward(q, k, v, causal, window, with_lse=True)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None):
    """Gradients ``(dq, dk, dv)`` of :func:`flash_attention` at its output
    ``out`` and log-sum-exp ``lse`` (:func:`flash_attention_lse`) for the
    upstream gradient ``dout`` (like q), in the inputs' shapes and dtype.
    On the card (bf16 or f16, hd in :data:`FLASH_BWD_HEAD_DIMS`) three
    launches counted here as one call (``flash_attention.bwd_launches``):
    D = rowsum(dout * out), the backward kernel, which adds dq into an f32
    scratch allocated here with bulk reduce-adds, and the scratch's
    conversion to the input dtype; the kernel reads ``lse`` in whole tiles
    of 64 rows, so it must be the padded view :func:`flash_attention_lse`
    returns.  On the CPU :func:`.ref.flash_attention_bwd_ref`."""
    from .build import load_library

    _check_flash(q, k, v, window)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)} and "
                         f"dout {tuple(dout.shape)} do not match q "
                         f"{tuple(q.shape)}")
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if tuple(lse.shape) != (B, H, S) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} "
                         f"{lse.dtype} is not ({B}, {H}, {S}) f32")
    if out.dtype != q.dtype or dout.dtype != q.dtype:
        raise TypeError("flash_attention_bwd: out and dout must be in q's "
                        "dtype")
    if not _on_cuda([q, k, v, out, lse, dout], "flash_attention_bwd"):
        return _ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                            causal=causal, window=window)
    if q.dtype == torch.float32 or hd not in FLASH_BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: the kernel takes bf16 and "
                         f"f16 at head dims {FLASH_BWD_HEAD_DIMS}, not "
                         f"{q.dtype} at {hd}")
    rows = -(-S // _LSE_ROWS) * _LSE_ROWS
    if not (lse.stride() == (H * rows, rows, 1) and _aligned(lse.data_ptr())
            and lse.untyped_storage().nbytes()
            >= 4 * (lse.storage_offset() + B * H * rows)):
        raise ValueError("flash_attention_bwd: on the card lse must be the "
                         "one flash_attention_lse returns, a view of a "
                         f"buffer padded to whole tiles of {_LSE_ROWS} rows")
    q, k, v, out, dout = (_tma_ready(t) for t in (q, k, v, out, dout))
    dvec = torch.empty((B, H, rows), dtype=torch.float32, device=q.device)
    dq_acc = torch.zeros((B, H, rows, hd), dtype=torch.float32,
                         device=q.device)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    lib = load_library()
    with torch.cuda.device(q.device):
        rc = lib.repro_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dvec.data_ptr(),
            dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _CODES[q.dtype], B, S, T, H, KV, hd, rows, int(causal),
            window or 0, torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on_error(lib, rc, "flash_attention_bwd")
    flash_attention.bwd_launches += 1
    return dq, dk, dv


# ------------------------------------------------------------------ RG-LRU
def rglru_scan(x: torch.Tensor, r_gate: torch.Tensor, i_gate: torch.Tensor,
               lam: torch.Tensor) -> torch.Tensor:
    """RG-LRU over (B,S,L) with the gate math fused in: a = exp(-8
    softplus(lam) r), g = sqrt(max(1 - a^2, 1e-12)) i x, h_t = a_t h_{t-1}
    + g_t from zero, as :func:`.ref.rglru_ref`.  x, r_gate and i_gate share
    one dtype (f32, bf16 or f16) and shape; lam is (L,) in any of those
    dtypes; any S and L.  The output is in x's dtype.  Forward only: on the
    card it raises when autograd would need its gradient.

    On the card the scan is chunked in time (``csrc/rglru.cu``): chunk
    aggregates, a carry over the chunks and each chunk rerun from its
    start state, in up to three CUDA launches counted here as one call;
    the aggregates go to scratch allocated here
    (:func:`rglru_scan_scratch_bytes`)."""
    from .build import load_library

    if x.dim() != 3:
        raise ValueError("rglru_scan: x must be (B, S, L)")
    if r_gate.shape != x.shape or i_gate.shape != x.shape:
        raise ValueError(f"rglru_scan: gates {tuple(r_gate.shape)}, "
                         f"{tuple(i_gate.shape)} do not match x "
                         f"{tuple(x.shape)}")
    B, S, L = x.shape
    if tuple(lam.shape) != (L,):
        raise ValueError(f"rglru_scan: lam {tuple(lam.shape)} is not ({L},)")
    for t in (x, r_gate, i_gate, lam):
        _check_dtype(t, "rglru_scan")
    if r_gate.dtype != x.dtype or i_gate.dtype != x.dtype:
        raise TypeError("rglru_scan: x and the gates must share one dtype")
    if not _on_cuda([x, r_gate, i_gate, lam], "rglru_scan"):
        return _ref.rglru_ref(x, r_gate, i_gate, lam)
    _check_contiguous([x, r_gate, i_gate, lam], "rglru_scan")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, r_gate, i_gate, lam)):
        raise RuntimeError("rglru_scan: the CUDA kernel is forward only; "
                           "call it under torch.no_grad()")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = load_library()
    scratch = torch.empty(rglru_scan_scratch_bytes(B, S, L),
                          dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.repro_rglru_scan(
            x.data_ptr(), r_gate.data_ptr(), i_gate.data_ptr(),
            lam.data_ptr(), out.data_ptr(), _CODES[x.dtype],
            _CODES[lam.dtype], B, S, L, scratch.data_ptr(), scratch.numel(),
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on_error(lib, rc, "rglru_scan")
    rglru_scan.launches += 1
    return out


rglru_scan.launches = 0


def rglru_scan_scratch_bytes(B: int, S: int, L: int) -> int:
    """Bytes of device scratch one call of the RG-LRU kernel at (B, S, L)
    takes: two f32 per (batch, chunk but the last, channel); 0 when S fits
    one chunk.  Asks the built library, which owns the chunk length."""
    from .build import load_library

    n = load_library().repro_rglru_scan_scratch(B, S, L)
    if n < 0:
        raise ValueError(f"rglru_scan: the kernel does not take ({B}, {S}, "
                         f"{L})")
    return n


# ------------------------------------------------------------------- WKV-6
WKV_HEAD_DIMS = (32, 64, 128)


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor):
    """WKV-6 over (B,S,H,hd) with an (hd, hd) f32 state per (batch, head)
    from zero: out_t = r_t^T (S + diag(u) k_t v_t^T), S <- diag(w_t) S +
    k_t v_t^T, as :func:`.ref.rwkv6_ref`.  r, k and v share one dtype
    (f32, bf16 or f16); w is f32 or r's dtype (an f32 decay is never
    rounded); u is (H, hd) f32; hd in :data:`WKV_HEAD_DIMS`; any S.
    Returns ``(out, final)``: out in r's dtype and the final state
    (B,H,hd,hd) f32, indexed [b, h, key, value].  Forward only: on the
    card it raises when autograd would need its gradient.

    On the card the recurrence is chunked in time (``csrc/wkv6.cu``): each
    chunk's state from zero, a carry over the chunks and each chunk rerun
    from its start state, in up to three CUDA launches counted here as one
    call; the chunk states go to scratch allocated here
    (:func:`rwkv6_wkv_scratch_bytes`)."""
    from .build import load_library

    if any(t.dim() != 4 for t in (r, k, v, w)):
        raise ValueError("rwkv6_wkv: r, k, v and w must be (B, S, H, hd)")
    B, S, H, hd = r.shape
    if any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"rwkv6_wkv: k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} and w {tuple(w.shape)} do not "
                         f"match r {tuple(r.shape)}")
    if tuple(u.shape) != (H, hd):
        raise ValueError(f"rwkv6_wkv: u {tuple(u.shape)} is not ({H}, {hd})")
    if hd not in WKV_HEAD_DIMS:
        raise ValueError(f"rwkv6_wkv: head dim {hd} is not one of "
                         f"{WKV_HEAD_DIMS}")
    for t in (r, k, v, w, u):
        _check_dtype(t, "rwkv6_wkv")
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError("rwkv6_wkv: r, k and v must share one dtype")
    if w.dtype not in (torch.float32, r.dtype):
        raise TypeError(f"rwkv6_wkv: w is {w.dtype}, not f32 or r's dtype")
    if u.dtype != torch.float32:
        raise TypeError(f"rwkv6_wkv: u is {u.dtype}, not f32")
    if not _on_cuda([r, k, v, w, u], "rwkv6_wkv"):
        return _ref.rwkv6_ref(r, k, v, w, u)
    _check_contiguous([r, k, v, w, u], "rwkv6_wkv")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u)):
        raise RuntimeError("rwkv6_wkv: the CUDA kernel is forward only; "
                           "call it under torch.no_grad()")
    out = torch.empty_like(r)
    final = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    if out.numel() == 0:
        return out, final.zero_()
    lib = load_library()
    scratch = torch.empty(rwkv6_wkv_scratch_bytes(B, S, H, hd),
                          dtype=torch.uint8, device=r.device)
    with torch.cuda.device(r.device):
        rc = lib.repro_rwkv6_wkv(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), out.data_ptr(), final.data_ptr(), _CODES[r.dtype],
            _CODES[w.dtype], B, S, H, hd, scratch.data_ptr(),
            scratch.numel(), torch.cuda.current_stream(r.device).cuda_stream)
    _raise_on_error(lib, rc, "rwkv6_wkv")
    rwkv6_wkv.launches += 1
    return out, final


rwkv6_wkv.launches = 0


def rwkv6_wkv_scratch_bytes(B: int, S: int, H: int, hd: int) -> int:
    """Bytes of device scratch one call of the WKV-6 kernel at (B, S, H,
    hd) takes: an (hd, hd) state and an hd decay in f32 per (batch, head,
    chunk but the last); 0 when S fits one chunk.  Asks the built library,
    which owns the chunk length."""
    from .build import load_library

    n = load_library().repro_rwkv6_wkv_scratch(B, S, H, hd)
    if n < 0:
        raise ValueError(f"rwkv6_wkv: the kernel does not take ({B}, {S}, "
                         f"{H}, {hd})")
    return n


def reset_launches() -> None:
    for fn in (convert_copy, bucket_pack, fused_pack, fused_unpack,
               flash_attention, rglru_scan, rwkv6_wkv):
        fn.launches = 0
    flash_attention.tc_launches = flash_attention.cuda_core_launches = 0
    flash_attention.lse_launches = flash_attention.bwd_launches = 0
