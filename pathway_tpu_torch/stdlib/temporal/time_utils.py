"""Time utilities (reference: python/pathway/stdlib/temporal/time_utils.py:
utc_now:37, inactivity_detection:64)."""

from __future__ import annotations

import datetime
import time as time_mod

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.schema import ColumnSchema, schema_from_columns
from pathway_tpu_torch.io._connector_runtime import (
    ConnectorSubjectBase,
    connector_table,
)


class _NowSubject(ConnectorSubjectBase):
    def __init__(self, refresh_rate: datetime.timedelta):
        super().__init__()
        self.refresh_rate = refresh_rate.total_seconds()

    def run(self) -> None:
        last_key = None
        while True:
            now = datetime.datetime.now(tz=datetime.timezone.utc)
            if last_key is not None:
                self._remove({"timestamp_utc": last_key})
            self.next(timestamp_utc=now)
            last_key = now
            self.commit()
            time_mod.sleep(self.refresh_rate)


def utc_now(refresh_rate: datetime.timedelta | None = None):
    """A 1-row table holding the current UTC time, refreshed periodically
    (reference: time_utils.py utc_now:37)."""
    refresh_rate = refresh_rate or datetime.timedelta(seconds=60)
    schema = schema_from_columns(
        {
            "timestamp_utc": ColumnSchema(
                name="timestamp_utc", dtype=dt.DATE_TIME_UTC
            )
        },
        name="UtcNowSchema",
    )
    return connector_table(
        schema, lambda: _NowSubject(refresh_rate), mode="streaming"
    )


def inactivity_detection(
    event_time_column,
    allowed_inactivity_period: datetime.timedelta,
    refresh_rate: datetime.timedelta | None = None,
    instance=None,
):
    """Detect inactivity periods: emits (inactive since, resumed at) alerts
    (reference: time_utils.py inactivity_detection:64)."""
    from pathway_tpu_torch.internals import reducers as red
    from pathway_tpu_torch.internals.expression import collect_tables

    tables = list(collect_tables(event_time_column, set()))
    if len(tables) != 1:
        raise ValueError("event_time_column must reference one table")
    table = tables[0]
    latest = table.reduce(latest_t=red.max_(event_time_column))
    now_t = utc_now(refresh_rate=refresh_rate)
    # inactivity: now - latest_t > allowed period
    joined = latest.join(now_t).select(
        latest_t=latest.latest_t,
        now=now_t.timestamp_utc,
    )
    alerts = joined.filter(
        joined.now - joined.latest_t > allowed_inactivity_period
    ).select(inactive_since=joined.latest_t)
    resumed = joined.filter(
        joined.now - joined.latest_t <= allowed_inactivity_period
    ).select(resumed_at=joined.latest_t)
    return alerts, resumed
