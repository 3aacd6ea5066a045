"""The KV fabric's engine side: committed KV pages that move between
engine replicas (counterpart of `paddle_tpu/serving/fabric.py`, pure host
code).

- **Page transfer.** An engine's committed prefix pages are read with its
  swap-out copy (`ServingEngine._extract_pages`, the host tier's payloads),
  framed by `encode_frame`, and grafted into another engine's radix tree
  (`RadixPrefixCache.graft` through `ServingEngine.import_prefix_frame`),
  which then continues `prompt + [t1]` with a full-prefix hit. int8 pages
  ship their codes and rowwise scales, e4m3 pages one byte an element,
  float pages their element bits (bf16 as its 16-bit patterns).
- **Persist and restore.** `RadixPrefixCache.snapshot()` records the whole
  tree, device pages and spilled host pages alike; `load()` rebuilds it in
  a fresh engine (`export_prefix_state` / `import_prefix_state`).
- **Prefix fingerprints.** A CRC chain over page-aligned token spans,
  seeded by the adapter id: `prompt_fingerprints` walks a prompt,
  `RadixPrefixCache.fingerprints` the tree, byte for byte alike.

Frame format (version 1), the JAX package's byte for byte: magic ``PKVF``,
a u32 header length, a JSON header (version, kv_dtype lane, page geometry,
adapter id, valid token count, per-page payload bytes), the token ids as
raw int64, then the pages' payloads back to back. A port payload is a
tuple, `(codes,)` or, for int8, `(codes, scales)`, so the codec reads the
lane from `kv_dtype`, never from the payload's type. Geometry is checked
whole on import: a frame from a mismatched engine is refused before any
page is grafted. The router's use of the fabric (the disaggregated
hand-off, affinity ranking, warm restart across replicas) comes with the
router.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
import zlib
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["FabricConfig", "resolve_fabric", "parse_fabric_spec",
           "FABRIC_ENV", "FRAME_VERSION", "FRAME_MAGIC",
           "encode_frame", "decode_frame", "frame_header",
           "fp_seed", "fp_step", "prompt_fingerprints"]

FABRIC_ENV = "PADDLE_TPU_KV_FABRIC"
FRAME_MAGIC = b"PKVF"
FRAME_VERSION = 1


# -- gate -----------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FabricConfig:
    """Tuning for the fleet KV fabric (constructed = fabric ON).

    `roles` maps replica name -> "prefill" | "decode": with at least
    one of each, the router runs DISAGGREGATED placement — a long
    prompt prefills on a prefill specialist at a 1-token budget, its
    pages transfer, and a decode specialist continues the stream.
    Without roles (the default) only warm restore + prefix-affinity
    ranking are active. `handoff_min_pages` is the minimum full
    prompt pages worth shipping (a short prompt re-prefills cheaper
    than it transfers); `summary_limit` caps each replica's
    fingerprint summary; `restore_on_add` gates the warm-deploy
    restore in `Router.add_replica`."""

    handoff_min_pages: int = 2
    summary_limit: int = 4096
    restore_on_add: bool = True
    roles: Optional[Mapping[str, str]] = None


def parse_fabric_spec(spec: str) -> Optional[FabricConfig]:
    """"off" -> None; "on" -> defaults; else "k=v,k=v" over
    min_pages / summary / restore (e.g. "min_pages=3,restore=off")."""
    low = spec.strip().lower()
    if low in ("off", "0", "false", "no", ""):
        return None
    if low in ("on", "1", "true", "yes"):
        return FabricConfig()
    kw = {}
    for part in low.split(","):
        k, sep, v = part.partition("=")
        k = k.strip()
        if not sep:
            raise ValueError(
                f"{FABRIC_ENV}: expected k=v, got {part!r}")
        if k == "min_pages":
            kw["handoff_min_pages"] = int(v)
        elif k == "summary":
            kw["summary_limit"] = int(v)
        elif k == "restore":
            kw["restore_on_add"] = v.strip() in ("on", "1", "true",
                                                 "yes")
        else:
            raise ValueError(
                f"{FABRIC_ENV}: unknown key {k!r} "
                "(want min_pages|summary|restore)")
    return FabricConfig(**kw)


def resolve_fabric(override=None) -> Optional[FabricConfig]:
    """The fabric gate: an explicit Router(fabric=...) wins (bool,
    spec string, or a FabricConfig); otherwise PADDLE_TPU_KV_FABRIC
    (default off). Returns None (off) or the active FabricConfig."""
    if override is not None:
        if isinstance(override, FabricConfig):
            return override
        if isinstance(override, bool):
            return FabricConfig() if override else None
        return parse_fabric_spec(str(override))
    return parse_fabric_spec(os.environ.get(FABRIC_ENV, "off"))


# -- prefix fingerprints --------------------------------------------------
def fp_seed(adapter_id: int = 0) -> int:
    """Chain seed: the adapter id joins the hash, so tenant A's
    fingerprints can never match tenant B's tree (the same isolation
    property the radix tree's per-adapter roots enforce)."""
    return zlib.crc32(struct.pack("<q", int(adapter_id)))


def fp_step(fp: int, span) -> int:
    """One page-edge hop: fold a full page's token ids into the
    running fingerprint. Must match byte-for-byte between the tree
    walk (RadixPrefixCache.fingerprints) and the prompt walk below."""
    return zlib.crc32(
        np.ascontiguousarray(np.asarray(span).reshape(-1),
                             dtype=np.int64).tobytes(), fp)


def prompt_fingerprints(prompt_ids, page_size: int,
                        adapter_id: int = 0
                        ) -> List[Tuple[int, int]]:
    """Fingerprints of every page-aligned prefix of `prompt_ids` the
    cache could serve — [(depth_pages, fp), ...] for depths 1..n.
    Capped at prompt_len - 1 tokens, matching the tree's own match
    limit (at least one token always prefills for logits)."""
    tok = np.ascontiguousarray(np.asarray(prompt_ids).reshape(-1),
                               dtype=np.int64)
    ps = int(page_size)
    limit = max(0, tok.size - 1)
    fp = fp_seed(adapter_id)
    out: List[Tuple[int, int]] = []
    depth = 0
    while depth + ps <= limit:
        fp = fp_step(fp, tok[depth:depth + ps])
        out.append((depth // ps + 1, fp))
        depth += ps
    return out


# -- transfer frame -------------------------------------------------------
def _bytes(x) -> bytes:
    """A tensor's (or an array's) bytes, C order: bf16 and e4m3 tensors
    through their raw bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous()
        if x.dtype in (torch.bfloat16, torch.float16) or \
                x.element_size() == 1:
            x = x.view(torch.uint8)
        return x.cpu().numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def _itemsize(x) -> int:
    return (x.element_size() if isinstance(x, torch.Tensor)
            else np.asarray(x).dtype.itemsize)


def _payload_blob(payload, kv_dtype: str) -> bytes:
    """One page payload -> wire bytes. A payload is what
    `ServingEngine._extract_pages` gives for one page (and the host tier
    stores): `(block,)`, the [n_layers, 2, page_size, H, D] block of a
    float or e4m3 pool, or `(codes, scales)` for int8, codes and their
    [n_layers, 2, page_size, H] f32 scales together (the pair IS the
    page)."""
    if kv_dtype == "int8":
        codes, scales = payload
        if isinstance(scales, torch.Tensor):
            scales = scales.float()
        else:
            scales = np.asarray(scales, np.float32)
        return _bytes(codes) + _bytes(scales)
    return _bytes(payload[0])


def encode_frame(*, kv_dtype: str, page_size: int, n_layers: int,
                 n_kv: int, head_dim: int, tokens,
                 payloads: Sequence, valid: int, adapter_id: int = 0,
                 fp_itemsize: Optional[int] = None) -> bytes:
    """Serialise a committed page chain into one versioned frame.

    `tokens` are the (at least `valid`) token ids the pages hold KV for,
    `payloads` one payload per page covering them. `fp_itemsize` is the
    float or e4m3 lane's bytes an element (the first payload's when
    omitted), recorded so the receiver checks that its pool agrees before
    it reinterprets the blob."""
    tok = np.ascontiguousarray(np.asarray(tokens).reshape(-1),
                               dtype=np.int64)
    valid = int(valid)
    if valid > tok.size:
        raise ValueError(f"valid={valid} exceeds tokens ({tok.size})")
    if valid > len(payloads) * int(page_size):
        raise ValueError(
            f"valid={valid} exceeds page capacity "
            f"({len(payloads)} pages x {page_size})")
    blob = b"".join(_payload_blob(p, kv_dtype) for p in payloads)
    if kv_dtype == "int8":
        itemsize = 1
    elif fp_itemsize is not None:
        itemsize = int(fp_itemsize)
    elif payloads:
        itemsize = _itemsize(payloads[0][0])
    else:
        itemsize = 4
    header = {
        "version": FRAME_VERSION,
        "kv_dtype": str(kv_dtype),
        "page_size": int(page_size),
        "n_layers": int(n_layers),
        "n_kv": int(n_kv),
        "head_dim": int(head_dim),
        "itemsize": itemsize,
        "adapter_id": int(adapter_id),
        "valid": valid,
        "n_tokens": int(tok.size),
        "n_pages": len(payloads),
        "payload_bytes": len(blob),
    }
    hdr = json.dumps(header, sort_keys=True,
                     separators=(",", ":")).encode("utf-8")
    return (FRAME_MAGIC + struct.pack("<I", len(hdr)) + hdr
            + tok.tobytes() + blob)


def frame_header(data: bytes) -> dict:
    """Parse and check just the frame header (no payload copy): the wire
    accounting and the geometry check's entry point."""
    if len(data) < 8 or data[:4] != FRAME_MAGIC:
        raise ValueError("not a KV fabric frame (bad magic)")
    (hlen,) = struct.unpack_from("<I", data, 4)
    try:
        header = json.loads(data[8:8 + hlen].decode("utf-8"))
    except Exception as exc:
        raise ValueError(f"corrupt fabric frame header: {exc!r}")
    version = header.get("version")
    if version != FRAME_VERSION:
        raise ValueError(
            f"fabric frame version {version!r} not supported "
            f"(this build speaks {FRAME_VERSION})")
    expect = (8 + hlen + 8 * int(header["n_tokens"])
              + int(header["payload_bytes"]))
    if len(data) != expect:
        raise ValueError(
            f"truncated fabric frame: {len(data)} bytes, header "
            f"promises {expect}")
    return header


def _tensor(data: bytes, dtype: torch.dtype, count: int, offset: int,
            shape) -> torch.Tensor:
    """`count` elements of `dtype` at `offset` of `data`, copied into a
    CPU tensor of `shape` (bf16 and other dtypes numpy lacks through
    their bits)."""
    width = torch.empty((), dtype=dtype).element_size()
    raw = np.frombuffer(data, dtype=np.uint8, count=count * width,
                        offset=offset).copy()
    return torch.from_numpy(raw).view(dtype).reshape(shape)


def decode_frame(data: bytes, fp_dtype: Optional[torch.dtype] = None
                 ) -> Tuple[dict, np.ndarray, List[tuple]]:
    """Frame bytes -> (header, tokens int64, per-page payloads), each
    payload a tuple of CPU tensors as `_extract_pages` gives them:
    `(codes int8, scales f32)` for int8 frames, `(block,)` otherwise in
    the receiver's pool element dtype `fp_dtype` (torch.float32 when
    omitted; torch.uint8 for e4m3 pools, whose planes move as bytes),
    whose width must match the header's or the frame is refused (a bf16
    pool cannot adopt an f32 frame byte for byte)."""
    header = frame_header(data)
    hlen = struct.unpack_from("<I", data, 4)[0]
    off = 8 + hlen
    n_tok = int(header["n_tokens"])
    tokens = np.frombuffer(data, dtype=np.int64, count=n_tok,
                           offset=off).copy()
    off += 8 * n_tok
    ps = int(header["page_size"])
    nl, nh, hd = (int(header["n_layers"]), int(header["n_kv"]),
                  int(header["head_dim"]))
    shape = (nl, 2, ps, nh, hd)
    n_elem = int(np.prod(shape))
    payloads: List[tuple] = []
    if header["kv_dtype"] == "int8":
        scale_shape = (nl, 2, ps, nh)
        n_scale = int(np.prod(scale_shape))
        for _ in range(int(header["n_pages"])):
            codes = _tensor(data, torch.int8, n_elem, off, shape)
            off += n_elem
            scales = _tensor(data, torch.float32, n_scale, off,
                             scale_shape)
            off += 4 * n_scale
            payloads.append((codes, scales))
    else:
        dt = torch.float32 if fp_dtype is None else fp_dtype
        width = torch.empty((), dtype=dt).element_size()
        if width != int(header["itemsize"]):
            raise ValueError(
                f"fabric frame element width {header['itemsize']}B "
                f"does not match receiver pool dtype {dt} "
                f"({width}B)")
        for _ in range(int(header["n_pages"])):
            payloads.append((_tensor(data, dt, n_elem, off, shape),))
            off += n_elem * width
    return header, tokens, payloads
