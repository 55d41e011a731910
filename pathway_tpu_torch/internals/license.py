"""License keys and entitlements (reference: src/engine/license.rs —
Ed25519-signed keys, `check_entitlements:99`, the free-tier 8-worker cap in
dataflow/config.rs:7-11 gated by the `unlimited-workers` entitlement).

Keys come in two formats:
  * `pw-v1.<b64 json>` — unsigned, accepted as-is (open-build escape
    hatch, and what `pw.set_license_key` docs show);
  * `pw-v2.<b64 json>.<b64 ed25519 sig>` — the payload is Ed25519-signed
    (pure-python RFC 8032 verify in internals/_ed25519.py, matching the
    reference's signed keys). The verifying public key defaults to the
    project key below; deployments minting their own keys override it via
    PATHWAY_LICENSE_PUBKEY (64 hex chars)."""

from __future__ import annotations

import base64
import json
import os
from dataclasses import dataclass, field
from typing import FrozenSet

# default verifying key for pw-v2 licenses (hex, 32 bytes). Generated for
# this open build; deployments override with PATHWAY_LICENSE_PUBKEY.
DEFAULT_LICENSE_PUBKEY = (
    "62e7082c9e648e52dc618bbfb4d8e262ff497a4d6d348fd9bdd4012e75f84dc3"
)

# the reference caps free-tier workers at 8 (config.rs:7-11)
FREE_TIER_WORKER_LIMIT = 8


class LicenseError(Exception):
    pass


@dataclass(frozen=True)
class License:
    tier: str = "free"
    entitlements: FrozenSet[str] = field(default_factory=frozenset)

    def check_entitlements(self, *required: str) -> None:
        """reference: license.rs check_entitlements:99."""
        missing = [e for e in required if e not in self.entitlements]
        if missing:
            raise LicenseError(
                f"license (tier={self.tier!r}) lacks entitlements: "
                f"{', '.join(missing)}"
            )

    @property
    def worker_limit(self) -> int | None:
        if "unlimited-workers" in self.entitlements:
            return None
        return FREE_TIER_WORKER_LIMIT


FREE = License()


def parse_license(key: str | None) -> License:
    """Accepts None (free tier), an unsigned `pw-v1.<base64 json>` key, or
    a signed `pw-v2.<base64 json>.<base64 sig>` key carrying
    {"tier": ..., "entitlements": [...]}; malformed or badly signed keys
    raise (reference: license.rs Ed25519-signed keys)."""
    if not key:
        return FREE
    if key.startswith("pw-v2."):
        parts = key.split(".")
        if len(parts) != 3:
            raise LicenseError(
                "pw-v2 keys have the form 'pw-v2.<payload>.<signature>'"
            )
        try:
            raw = base64.urlsafe_b64decode(parts[1] + "==")
            sig = base64.urlsafe_b64decode(parts[2] + "==")
        except Exception as exc:  # noqa: BLE001
            raise LicenseError(f"license key unreadable: {exc}") from exc
        _verify_signature(raw, sig)
        try:
            payload = json.loads(raw)
        except Exception as exc:  # noqa: BLE001
            raise LicenseError(
                f"license key payload unreadable: {exc}"
            ) from exc
    elif key.startswith("pw-v1."):
        if os.environ.get("PATHWAY_LICENSE_PUBKEY"):
            # a deployment that configured a verifying key has opted into
            # real enforcement: unsigned keys no longer count
            raise LicenseError(
                "unsigned pw-v1 keys are not accepted when "
                "PATHWAY_LICENSE_PUBKEY is configured; mint a signed "
                "pw-v2 key (internals.license.make_signed_key)"
            )
        try:
            payload = json.loads(
                base64.b64decode(key[len("pw-v1."):] + "==")
            )
        except Exception as exc:  # noqa: BLE001
            raise LicenseError(
                f"license key payload unreadable: {exc}"
            ) from exc
    else:
        raise LicenseError(
            "unrecognized license key format "
            "(expected 'pw-v1.<payload>' or 'pw-v2.<payload>.<sig>')"
        )
    if not isinstance(payload, dict):
        raise LicenseError(
            f"license key payload must be a JSON object, got "
            f"{type(payload).__name__}"
        )
    return License(
        tier=str(payload.get("tier", "enterprise")),
        entitlements=frozenset(payload.get("entitlements", ())),
    )


def _verify_signature(payload: bytes, signature: bytes) -> None:
    """Ed25519 over the raw payload bytes (reference: license.rs)."""
    from pathway_tpu_torch.internals import _ed25519

    pub_hex = os.environ.get(
        "PATHWAY_LICENSE_PUBKEY", DEFAULT_LICENSE_PUBKEY
    )
    try:
        pub = bytes.fromhex(pub_hex)
    except ValueError as exc:
        raise LicenseError(
            f"PATHWAY_LICENSE_PUBKEY is not valid hex: {exc}"
        ) from exc
    if not _ed25519.verify(pub, payload, signature):
        raise LicenseError("license key signature verification failed")


def make_signed_key(secret: bytes, payload: dict) -> str:
    """Mint a pw-v2 key (operator tooling + tests): sign the JSON payload
    with an Ed25519 secret whose public key the deployment configures via
    PATHWAY_LICENSE_PUBKEY."""
    from pathway_tpu_torch.internals import _ed25519

    raw = json.dumps(payload, sort_keys=True).encode()
    sig = _ed25519.sign(secret, raw)
    return (
        "pw-v2."
        + base64.urlsafe_b64encode(raw).decode().rstrip("=")
        + "."
        + base64.urlsafe_b64encode(sig).decode().rstrip("=")
    )


def current_license() -> License:
    from pathway_tpu_torch.internals.config import pathway_config

    return parse_license(pathway_config.license_key)


def check_worker_count(workers: int) -> None:
    """reference: the >8-worker gate in dataflow/config.rs:7-11."""
    limit = current_license().worker_limit
    if limit is not None and workers > limit:
        raise LicenseError(
            f"{workers} workers requested but the free tier allows at most "
            f"{limit}; set a license key with the 'unlimited-workers' "
            "entitlement (pw.set_license_key)"
        )
