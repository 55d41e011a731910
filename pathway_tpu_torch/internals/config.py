"""Runtime configuration from environment (reference:
python/pathway/internals/config.py:65 PathwayConfig, PATHWAY_* env vars;
src/engine/dataflow/config.rs)."""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def _env_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.lower() in ("1", "true", "yes", "on")


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    try:
        return int(v) if v is not None else default
    except ValueError:
        return default


@dataclass
class PathwayConfig:
    ignore_asserts: bool = field(
        default_factory=lambda: _env_bool("PATHWAY_IGNORE_ASSERTS")
    )
    runtime_typechecking: bool = field(
        default_factory=lambda: _env_bool("PATHWAY_RUNTIME_TYPECHECKING")
    )
    threads: int = field(default_factory=lambda: _env_int("PATHWAY_THREADS", 1))
    processes: int = field(default_factory=lambda: _env_int("PATHWAY_PROCESSES", 1))
    process_id: int = field(default_factory=lambda: _env_int("PATHWAY_PROCESS_ID", 0))
    first_port: int = field(
        default_factory=lambda: _env_int("PATHWAY_FIRST_PORT", 10000)
    )
    license_key: str | None = field(
        default_factory=lambda: os.environ.get("PATHWAY_LICENSE_KEY")
    )
    monitoring_server: str | None = field(
        default_factory=lambda: os.environ.get("PATHWAY_MONITORING_SERVER")
    )
    persistence_mode: str | None = None
    replay_storage: str | None = field(
        default_factory=lambda: os.environ.get("PATHWAY_REPLAY_STORAGE")
    )
    replay_mode: str | None = field(
        default_factory=lambda: os.environ.get("PATHWAY_REPLAY_MODE")
    )

    @property
    def worker_count(self) -> int:
        return self.threads * self.processes


pathway_config = PathwayConfig()


def set_license_key(key: str | None) -> None:
    pathway_config.license_key = key


def set_monitoring_config(*, server_endpoint: str | None = None, **kwargs) -> None:
    pathway_config.monitoring_server = server_endpoint
    from pathway_tpu_torch.internals import telemetry

    telemetry.set_monitoring_config(server_endpoint=server_endpoint, **kwargs)
