"""Analytic FLOPs/bytes cost model (counterpart of
pathway_tpu/internals/costmodel.py).

The live `pathway_device_mfu_pct` gauge and the DevicePipeline's
`useful_flops` derive from the formulas here. The port's differences: the
device name comes from torch.cuda, and the peak tables hold the H100.

Contract (documented in ARCHITECTURE.md "Device utilization"):

  * USEFUL FLOPs count real mask tokens only.  Bucketing and slab
    packing pad, but padding is not useful work; MFU judged on padded
    tokens would reward waste.
  * encoder per-token forward FLOPs at sequence length ``seq``::

        layers * (2 * (4*h*h + 2*h*ffn)   # q,k,v,o projections + MLP
                  + 2 * 2 * seq * h)      # attention scores + mix

    (matmul FLOPs = 2 * MACs; norms/softmax/gathers are <2% at MiniLM
    shapes and are deliberately excluded, matching the bench).
  * decoder FLOPs/token ~= 2 * n_params — the standard inference
    roofline count; attention against a short KV cache adds <2%.
  * peak FLOP/s and HBM bytes/s come from a device-name keyed table of
    published bf16 numbers; unknown devices (including the CPU CI
    backend) return 0.0 and every consumer must treat 0.0 as "peak
    unknown -> MFU undefined", never divide by it.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

# MiniLM-L6 geometry — the repo's ingest encoder (models/minilm.py).
MINILM_HIDDEN = 384
MINILM_MLP_DIM = 1536
MINILM_LAYERS = 6

# Published dense peak bf16 FLOP/s per card, keyed on lower-cased
# substrings of torch.cuda.get_device_name (NVIDIA's data sheet, H100 SXM
# at its 700 W limit).
DEVICE_PEAK_BF16_FLOPS: Dict[str, float] = {
    "h100": 989e12,
}

# Published HBM bandwidth, same keying.
DEVICE_HBM_BYTES_PER_SEC: Dict[str, float] = {
    "h100": 3.35e12,
}

# Published per-card HBM capacity, same keying; unknown devices return
# 0.0 and consumers report None.
DEVICE_HBM_BYTES: Dict[str, float] = {
    "h100": 80e9,
}

_lock = threading.Lock()
_cached_name: Optional[str] = None


def device_name() -> str:
    """Name of CUDA device 0, cached; "unknown" without a CUDA card."""
    global _cached_name
    with _lock:
        if _cached_name is None:
            try:
                import torch

                _cached_name = (
                    torch.cuda.get_device_name(0)
                    if torch.cuda.is_available()
                    else "unknown"
                )
            except Exception:  # noqa: BLE001 — no backend is a valid state
                _cached_name = "unknown"
        return _cached_name


def _lookup(table: Dict[str, float], name: Optional[str]) -> float:
    lowered = (name if name is not None else device_name()).lower()
    for key, value in table.items():
        if key in lowered:
            return value
    return 0.0


def device_peak_flops(name: Optional[str] = None) -> float:
    """Peak bf16 FLOP/s of `name` (default: the attached chip); 0.0 for
    unknown devices — consumers must report MFU as None, not divide."""
    return _lookup(DEVICE_PEAK_BF16_FLOPS, name)


def device_capacity_known(name: Optional[str] = None) -> bool:
    """Whether the chip table has a peak-FLOPs entry for `name` (default:
    the attached chip).  False on CPU CI and unrecognized devices — the
    cost ledger's efficiency gauges then report None, which analyzer
    PWT802 surfaces so the gap is a finding instead of a silent hole."""
    return device_peak_flops(name) > 0.0


def device_hbm_bytes_per_sec(name: Optional[str] = None) -> float:
    """HBM bytes/s of `name` (default: the attached chip); 0.0 unknown."""
    return _lookup(DEVICE_HBM_BYTES_PER_SEC, name)


def device_hbm_bytes(name: Optional[str] = None) -> float:
    """HBM capacity in bytes of `name` (default: the attached chip);
    0.0 for unknown devices — consumers report headroom as None."""
    return _lookup(DEVICE_HBM_BYTES, name)


def encoder_param_count(
    *,
    vocab_size: int,
    hidden: int,
    layers: int,
    mlp_dim: int,
    max_len: int,
) -> int:
    """Exact parameter count of models/transformer.init_params for this
    geometry: embed (v,h) + pos_embed (max_len,h) + final LN 2h, and per
    layer two LNs (4h), qkv (3h^2)+3h, out (h^2)+h, up (h*m)+m, down
    (m*h)+h.  Kept in lockstep with init_params — the PWT699 parity gate
    compares this prediction against live leaf sizes."""
    h, m = hidden, mlp_dim
    per_layer = 4 * h * h + 2 * h * m + 9 * h + m
    return vocab_size * h + max_len * h + 2 * h + layers * per_layer


def encoder_param_bytes(config: Any) -> int:
    """Parameter bytes (float32) for a TransformerConfig-shaped object."""
    return 4 * encoder_param_count(
        vocab_size=int(getattr(config, "vocab_size", 30522)),
        hidden=int(getattr(config, "hidden", MINILM_HIDDEN)),
        layers=int(getattr(config, "layers", MINILM_LAYERS)),
        mlp_dim=int(getattr(config, "mlp_dim", MINILM_MLP_DIM)),
        max_len=int(getattr(config, "max_len", 512)),
    )


def encoder_flops_per_token(
    seq: float,
    *,
    hidden: int = MINILM_HIDDEN,
    mlp_dim: int = MINILM_MLP_DIM,
    layers: int = MINILM_LAYERS,
) -> float:
    """Forward FLOPs for ONE token of an encoder layer stack at sequence
    length `seq`: per layer, 2*(4*h*h) for the q/k/v/o projections,
    2*(2*h*ffn) for the MLP, and 2*2*seq*h for attention scores + mix."""
    h = hidden
    return layers * (2 * (4 * h * h + 2 * h * mlp_dim) + 2 * 2 * seq * h)


def encoder_flops_per_doc(
    tokens_per_doc: float,
    *,
    hidden: int = MINILM_HIDDEN,
    mlp_dim: int = MINILM_MLP_DIM,
    layers: int = MINILM_LAYERS,
) -> float:
    """Useful forward FLOPs for one document of `tokens_per_doc` REAL
    tokens (seq = tokens_per_doc: a doc attends within itself)."""
    return (
        encoder_flops_per_token(
            tokens_per_doc, hidden=hidden, mlp_dim=mlp_dim, layers=layers
        )
        * tokens_per_doc
    )


def encoder_useful_flops(
    real_tokens: int,
    rows: int,
    *,
    hidden: int = MINILM_HIDDEN,
    mlp_dim: int = MINILM_MLP_DIM,
    layers: int = MINILM_LAYERS,
) -> float:
    """Useful FLOPs of a dispatched batch: `real_tokens` mask tokens
    over `rows` documents, attention charged at the batch's average
    real sequence length (padding excluded — see module contract)."""
    if real_tokens <= 0:
        return 0.0
    seq = real_tokens / max(rows, 1)
    return real_tokens * encoder_flops_per_token(
        seq, hidden=hidden, mlp_dim=mlp_dim, layers=layers
    )


def encoder_flops_for_config(config: Any, real_tokens: int, rows: int) -> float:
    """`encoder_useful_flops` with the geometry read off a
    TransformerConfig (hidden / mlp_dim / layers attributes)."""
    return encoder_useful_flops(
        real_tokens,
        rows,
        hidden=int(getattr(config, "hidden", MINILM_HIDDEN)),
        mlp_dim=int(getattr(config, "mlp_dim", MINILM_MLP_DIM)),
        layers=int(getattr(config, "layers", MINILM_LAYERS)),
    )


def decoder_flops_per_token(n_params: int) -> float:
    """Decoder FLOPs per generated/prefilled token ~= 2 * n_params
    (matmul MACs once through the weights)."""
    return 2.0 * float(n_params)


def mfu_pct(flops_per_sec: float, peak: Optional[float] = None) -> Optional[float]:
    """Achieved model-FLOPs utilization in percent, or None when the
    device peak is unknown (CPU CI, new chip generations)."""
    p = device_peak_flops() if peak is None else peak
    if not p:
        return None
    return 100.0 * flops_per_sec / p


def _reset_cache_for_tests() -> None:
    global _cached_name
    with _lock:
        _cached_name = None
