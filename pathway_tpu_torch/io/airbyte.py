"""pw.io.airbyte — Airbyte-sourced connector (reference:
python/pathway/io/airbyte — read:345, Docker/Cloud Run runner in logic.py;
full-refresh and incremental sync modes over the Airbyte protocol).

An Airbyte source is any runner producing Airbyte-protocol JSON lines
(RECORD / STATE messages). `DockerAirbyteSource` shells out to the
connector image via docker; tests inject a runner emitting protocol lines.
"""

from __future__ import annotations

import json
import logging
import os
import re
import subprocess
import tempfile
import time as time_mod
from typing import Any, Dict, Iterable, List, Optional

import yaml

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.schema import ColumnSchema, schema_from_columns
from pathway_tpu_torch.io._connector_runtime import (
    ConnectorSubjectBase,
    connector_table,
)


class AirbyteSourceRunner:
    """Produces Airbyte protocol messages (dicts) for one sync run.

    Shared machinery for every execution backend: configured-catalog
    construction, tolerant protocol parsing, and an injectable command
    executor (tests pass `_execute`)."""

    _execute = None  # injectable: fn(args) -> stdout text

    def sync(self, state: Any) -> Iterable[dict]:
        raise NotImplementedError

    def cleanup(self) -> None:
        """Release backend resources (venv dir, cloud job)."""

    def _configured_catalog(self, state) -> dict:
        return {
            "streams": [
                {
                    "stream": {"name": s, "json_schema": {}},
                    "sync_mode": "incremental" if state else "full_refresh",
                    "destination_sync_mode": "append",
                }
                for s in self.streams
            ]
        }

    def _exec(self, args: List[str]) -> str:
        if self._execute is not None:
            return self._execute(args)
        return subprocess.run(
            args, check=True, capture_output=True, text=True
        ).stdout

    @staticmethod
    def _parse_protocol(lines: Iterable[str]) -> Iterable[dict]:
        for line in lines:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                continue


class DockerAirbyteSource(AirbyteSourceRunner):
    """Runs an Airbyte connector image with `docker run` (reference:
    io/airbyte/logic.py docker runner)."""

    def __init__(self, image: str, config: dict, streams: List[str]):
        self.image = image
        self.config = config
        self.streams = streams

    def sync(self, state):
        with tempfile.TemporaryDirectory() as tmp:
            cfg = f"{tmp}/config.json"
            with open(cfg, "w") as fh:
                json.dump(self.config, fh)
            cat = f"{tmp}/catalog.json"
            with open(cat, "w") as fh:
                json.dump(self._configured_catalog(state), fh)
            cmd = [
                "docker", "run", "--rm", "-v", f"{tmp}:/cfg",
                self.image, "read", "--config", "/cfg/config.json",
                "--catalog", "/cfg/catalog.json",
            ]
            if state is not None:
                st = f"{tmp}/state.json"
                with open(st, "w") as fh:
                    json.dump(state, fh)
                cmd += ["--state", "/cfg/state.json"]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
            yield from self._parse_protocol(proc.stdout)
            proc.wait()


class VenvAirbyteSource(AirbyteSourceRunner):
    """Runs a pip-installable Airbyte connector inside a private venv
    (reference: third_party/airbyte_serverless venv execution)."""

    def __init__(self, package: str, config: dict, streams: List[str], *, _execute=None):
        self.package = package
        self.config = config
        self.streams = streams
        self._execute = _execute
        self._venv = None

    def _entrypoint(self) -> str:
        """Console-script path: Airbyte convention names the script after
        the connector (`airbyte-source-faker` installs `source-faker`)."""
        base = re.split(r"[=<>!\[ ]", self.package)[0]
        candidates = [base]
        if base.startswith("airbyte-"):
            candidates.insert(0, base[len("airbyte-"):])
        for cand in candidates:
            path = os.path.join(self._venv, "bin", cand)
            if self._execute is not None or os.path.exists(path):
                return path
        bin_dir = os.path.join(self._venv, "bin")
        if os.path.isdir(bin_dir):
            for f in sorted(os.listdir(bin_dir)):
                if f.startswith(("source-", "destination-")):
                    return os.path.join(bin_dir, f)
        raise FileNotFoundError(
            f"no connector entrypoint found in {bin_dir} for {self.package}"
        )

    def sync(self, state):
        import sys

        if self._venv is None:
            self._venv = tempfile.mkdtemp(prefix="pw_airbyte_venv_")
            self._exec([sys.executable, "-m", "venv", self._venv])
            self._exec([f"{self._venv}/bin/pip", "install", self.package])
        with tempfile.TemporaryDirectory() as tmp:
            cfg = f"{tmp}/config.json"
            with open(cfg, "w") as fh:
                json.dump(self.config, fh)
            cat = f"{tmp}/catalog.json"
            with open(cat, "w") as fh:
                json.dump(self._configured_catalog(state), fh)
            args = [
                self._entrypoint(), "read",
                "--config", cfg, "--catalog", cat,
            ]
            if state is not None:
                st = f"{tmp}/state.json"
                with open(st, "w") as fh:
                    json.dump(state, fh)
                args += ["--state", st]
            out = self._exec(args)
        yield from self._parse_protocol(out.splitlines())

    def cleanup(self) -> None:
        if self._venv is not None:
            import shutil

            shutil.rmtree(self._venv, ignore_errors=True)
            self._venv = None


# bootstrap script run inside the Cloud Run job: Airbyte images export
# AIRBYTE_ENTRYPOINT; config/catalog/state arrive base64-encoded in env
# vars set per execution (the same scheme the reference's
# airbyte_serverless remote runner uses)
_CLOUD_RUN_WRAPPER = (
    'echo $AIRBYTE_CONFIG_B64 | base64 -d > /tmp/config.json; '
    'echo $AIRBYTE_CATALOG_B64 | base64 -d > /tmp/catalog.json; '
    'if [ -n "$AIRBYTE_STATE_B64" ]; then '
    'echo $AIRBYTE_STATE_B64 | base64 -d > /tmp/state.json; '
    'STATE_ARGS="--state /tmp/state.json"; fi; '
    '$AIRBYTE_ENTRYPOINT read --config /tmp/config.json '
    '--catalog /tmp/catalog.json $STATE_ARGS; '
    # terminal sentinel: Cloud Logging ingestion is eventually consistent,
    # so the reader polls until it sees this line (or times out) before
    # trusting that the tail of the protocol stream has landed.  Preserve
    # the connector's exit status so a crashed connector still fails the
    # job (and `--wait` still raises) instead of echo masking it with 0.
    'rc=$?; echo PATHWAY_AIRBYTE_SYNC_DONE; exit $rc'
)

# how long to keep polling Cloud Logging for the sync's tail to land
_LOG_POLL_TIMEOUT_S = 120.0
_LOG_POLL_INTERVAL_S = 3.0


class CloudRunAirbyteSource(AirbyteSourceRunner):
    """Executes the connector as a Google Cloud Run job (reference:
    io/airbyte read(execution_type="remote") over the airbyte_serverless
    remote runner). The job wraps the image entrypoint in a shell that
    decodes config/catalog/state from env vars; protocol output is read
    back from Cloud Logging for the specific execution. Shells out to
    `gcloud` (ambient credentials); tests inject `_execute`."""

    def __init__(
        self,
        image: str,
        config: dict,
        streams: List[str],
        *,
        region: str = "europe-west1",
        job_name: str | None = None,
        env_vars: dict | None = None,
        log_poll_timeout: float = _LOG_POLL_TIMEOUT_S,
        log_poll_interval: float = _LOG_POLL_INTERVAL_S,
        _execute=None,
    ):
        import uuid

        self.log_poll_timeout = log_poll_timeout
        self.log_poll_interval = log_poll_interval

        self.image = image
        self.config = config
        self.streams = streams
        self.region = region
        self._auto_named = job_name is None
        self.job_name = job_name or f"pw-airbyte-{uuid.uuid4().hex[:12]}"
        self.env_vars = env_vars or {}
        self._execute = _execute
        self._created = False

    def sync(self, state):
        import base64

        if not self._created:
            env_flags = []
            for k, v in self.env_vars.items():
                env_flags += ["--set-env-vars", f"{k}={v}"]
            self._exec(
                [
                    "gcloud", "run", "jobs", "create", self.job_name,
                    "--image", self.image, "--region", self.region,
                    "--max-retries", "0",
                    "--command", "/bin/sh",
                    "--args", "-c," + _CLOUD_RUN_WRAPPER,
                ]
                + env_flags
            )
            self._created = True

        def b64(obj) -> str:
            return base64.b64encode(json.dumps(obj).encode()).decode()

        env = (
            f"AIRBYTE_CONFIG_B64={b64(self.config)},"
            f"AIRBYTE_CATALOG_B64={b64(self._configured_catalog(state))}"
        )
        if state is not None:
            env += f",AIRBYTE_STATE_B64={b64(state)}"
        execution = self._exec(
            [
                "gcloud", "run", "jobs", "execute", self.job_name,
                "--region", self.region, "--wait",
                "--update-env-vars", env,
                "--format", "value(metadata.name)",
            ]
        ).strip()
        exec_filter = (
            'resource.type="cloud_run_job" AND '
            f'labels."run.googleapis.com/execution_name"="{execution}"'
        )
        sentinel_cmd = [
            "gcloud", "logging", "read",
            exec_filter + ' AND textPayload="PATHWAY_AIRBYTE_SYNC_DONE"',
            "--format", "value(textPayload)",
            "--limit", "1",
        ]
        read_cmd = [
            "gcloud", "logging", "read",
            exec_filter,
            "--format", "value(textPayload)",
            "--order", "asc",
        ]
        # `jobs execute --wait` returning does NOT mean the logs have been
        # ingested: Cloud Logging lags by seconds, and a missing final
        # STATE message silently causes re-reads or gaps on the next
        # incremental sync.  Phase 1: poll a cheap sentinel-only query (so
        # large syncs are not re-downloaded every 3s) until the wrapper's
        # terminal line is ingested or we time out.
        deadline = time_mod.monotonic() + self.log_poll_timeout
        while (
            "PATHWAY_AIRBYTE_SYNC_DONE" not in self._exec(sentinel_cmd)
            and time_mod.monotonic() < deadline
        ):
            time_mod.sleep(self.log_poll_interval)
        # Phase 2: full ordered read.  Cloud Logging does not guarantee
        # cross-entry ingestion order, so the sentinel landing first does
        # not mean the tail did — re-read until the line count is stable
        # across two consecutive reads (still bounded by the deadline).
        logs = self._exec(read_cmd)
        while time_mod.monotonic() < deadline:
            time_mod.sleep(self.log_poll_interval)
            again = self._exec(read_cmd)
            if again.count("\n") == logs.count("\n"):
                logs = again
                break
            logs = again
        if "PATHWAY_AIRBYTE_SYNC_DONE" not in logs:
            # settle for what has landed, but loudly: a missing tail can
            # drop the final STATE message and cause re-reads/gaps on the
            # next incremental sync
            logging.getLogger(__name__).warning(
                "airbyte cloud-run sync %s: log stream still incomplete "
                "after %.0fs of polling; the final STATE message may be "
                "missing and the next incremental sync may re-read or "
                "skip records",
                execution,
                self.log_poll_timeout,
            )
        yield from self._parse_protocol(logs.splitlines())

    def cleanup(self) -> None:
        if self._created and self._auto_named:
            # auto-named jobs would otherwise accumulate in the project
            try:
                self._exec(
                    [
                        "gcloud", "run", "jobs", "delete", self.job_name,
                        "--region", self.region, "--quiet",
                    ]
                )
            except Exception:  # noqa: BLE001
                pass
            self._created = False


class _AirbyteSubject(ConnectorSubjectBase):
    def __init__(self, runner: AirbyteSourceRunner, streams, mode, refresh_interval):
        super().__init__()
        self.runner = runner
        self.streams = set(streams) if streams else None
        self.mode = mode
        self.refresh_interval = refresh_interval
        self._state: Any = None

    def run(self) -> None:
        from pathway_tpu_torch.engine.value import Json

        while True:
            got = False
            for msg in self.runner.sync(self._state):
                mtype = msg.get("type")
                if mtype == "RECORD":
                    rec = msg["record"]
                    if self.streams and rec.get("stream") not in self.streams:
                        continue
                    self.next(data=Json(rec.get("data", {})))
                    got = True
                elif mtype == "STATE":
                    self._state = msg.get("state")
            if got:
                self.commit()
            if self.mode == "static" or self._state is None:
                return  # full-refresh source: one sync per run
            time_mod.sleep(self.refresh_interval)

    def on_stop(self) -> None:
        self.runner.cleanup()

    def _persisted_state(self):
        return {"state": self._state}

    def _restore_persisted_state(self, state) -> None:
        if state:
            self._state = state.get("state")


def read(
    config_file_path: str | None = None,
    streams: List[str] | None = None,
    *,
    mode: str = "streaming",
    refresh_interval_ms: int = 60_000,
    execution_type: str = "local",
    gcp_region: str = "europe-west1",
    gcp_job_name: str | None = None,
    name: str | None = None,
    _runner: AirbyteSourceRunner | None = None,
    **kwargs,
):
    """Read records from an Airbyte connector (reference: io/airbyte
    read:345). The connector config yaml is produced by
    `pathway airbyte create-source` (cli.py:311)."""
    if _runner is None:
        with open(config_file_path) as fh:
            config = yaml.safe_load(fh)
        source = config.get("source", config)
        image = source.get("docker_image") or source.get("image")
        conf = source.get("config", {})
        if execution_type == "remote":
            _runner = CloudRunAirbyteSource(
                image,
                conf,
                streams or [],
                region=gcp_region,
                job_name=gcp_job_name,
            )
        else:
            _runner = DockerAirbyteSource(image, conf, streams or [])
    schema = schema_from_columns(
        {"data": ColumnSchema(name="data", dtype=dt.JSON)}, name="AirbyteSchema"
    )

    def factory():
        return _AirbyteSubject(
            _runner, streams, mode, refresh_interval_ms / 1000.0
        )

    return connector_table(schema, factory, mode=mode, name=name)


def _sample_config_from_spec(image: str) -> dict:
    """Derive a sample config from the connector's `spec` command; empty
    template when docker is unavailable (reference: the airbyte_serverless
    template renders the spec's properties)."""
    try:
        out = subprocess.run(
            ["docker", "run", "--rm", image, "spec"],
            capture_output=True,
            text=True,
            timeout=120,
            check=True,
        ).stdout
    except Exception:  # noqa: BLE001 — docker missing/unpullable
        return {}
    for msg in AirbyteSourceRunner._parse_protocol(out.splitlines()):
        if msg.get("type") == "SPEC":
            props = (
                msg.get("spec", {})
                .get("connectionSpecification", {})
                .get("properties", {})
            )
            return {
                k: v.get("default", f"<{v.get('type', 'value')}>")
                for k, v in props.items()
            }
    return {}


def create_connection_config(
    name: str, image: str, *, folder: str = "connections"
) -> str:
    """Backend of `pathway airbyte create-source` (reference: cli.py:311,
    third_party/airbyte_serverless/connections.py ConnectionFromFile):
    writes `connections/<name>.yaml` in the shape `pw.io.airbyte.read`
    consumes, with a sample config from the connector spec when docker is
    available."""
    path = os.path.join(folder, f"{name}.yaml")
    if os.path.exists(path):
        raise FileExistsError(
            f"Connection {name!r} already exists. "
            f"Delete `{path}` and run this command again to re-init it."
        )
    sample = _sample_config_from_spec(image)
    os.makedirs(folder, exist_ok=True)
    doc = {
        "source": {"docker_image": image, "config": sample, "streams": []}
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        yaml.safe_dump(doc, fh, sort_keys=False)
    os.replace(tmp, path)
    return path
