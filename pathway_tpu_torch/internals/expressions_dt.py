"""`.dt` datetime expression namespace.

TPU-native rebuild of the reference datetime expression surface (reference:
python/pathway/internals/expressions/date_time.py, src/engine/time.rs).
Naive and UTC datetimes are python `datetime.datetime` (tz-aware for UTC);
durations are `datetime.timedelta`.

>>> import pathway_tpu_torch as pw
>>> t = pw.debug.table_from_markdown('''
... s
... 2024-05-01T12:30:00
... ''')
>>> stamped = t.select(ts=pw.this.s.dt.strptime("%Y-%m-%dT%H:%M:%S"))
>>> r = stamped.select(y=pw.this.ts.dt.year(), h=pw.this.ts.dt.hour())
>>> pw.debug.compute_and_print(r, include_id=False)
y    | h
2024 | 12
"""

from __future__ import annotations

import datetime
from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import MethodCallExpression, smart_wrap


def _parse_tz(timezone: str):
    from zoneinfo import ZoneInfo

    return ZoneInfo(timezone)


_STRFTIME_MAP = [
    ("%DD", "%d"),
    ("%MM", "%m"),
    ("%YYYY", "%Y"),
    ("%HH", "%H"),
    ("%mm", "%M"),
    ("%SS", "%S"),
]


class DateTimeNamespace:
    def __init__(self, expr):
        self._expr = smart_wrap(expr)

    def _call(self, name, fun, *args, return_type=None):
        return MethodCallExpression(
            f"dt.{name}", self._expr, *args, fun=fun, return_type=return_type
        )

    def year(self):
        return self._call("year", lambda v: v.year, return_type=dt.INT)

    def month(self):
        return self._call("month", lambda v: v.month, return_type=dt.INT)

    def day(self):
        return self._call("day", lambda v: v.day, return_type=dt.INT)

    def hour(self):
        return self._call("hour", lambda v: v.hour, return_type=dt.INT)

    def minute(self):
        return self._call("minute", lambda v: v.minute, return_type=dt.INT)

    def second(self):
        return self._call("second", lambda v: v.second, return_type=dt.INT)

    def millisecond(self):
        return self._call(
            "millisecond", lambda v: v.microsecond // 1000, return_type=dt.INT
        )

    def microsecond(self):
        return self._call("microsecond", lambda v: v.microsecond, return_type=dt.INT)

    def nanosecond(self):
        return self._call(
            "nanosecond", lambda v: v.microsecond * 1000, return_type=dt.INT
        )

    def timestamp(self, unit: str = "ns"):
        mult = {"ns": 1e9, "us": 1e6, "ms": 1e3, "s": 1.0}[unit]

        def fun(v):
            if v.tzinfo is None:
                epoch = datetime.datetime(1970, 1, 1)
            else:
                epoch = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
            return (v - epoch).total_seconds() * mult

        return self._call("timestamp", fun, return_type=dt.FLOAT)

    def strftime(self, fmt):
        def fun(v, f):
            for ours, py in _STRFTIME_MAP:
                f = f.replace(ours, py)
            return v.strftime(f)

        return self._call("strftime", fun, smart_wrap(fmt), return_type=dt.STR)

    def strptime(self, fmt, contains_timezone: bool | None = None):
        def fun(v, f):
            for ours, py in _STRFTIME_MAP:
                f = f.replace(ours, py)
            return datetime.datetime.strptime(v, f)

        return self._call(
            "strptime", fun, smart_wrap(fmt), return_type=dt.DATE_TIME_NAIVE
        )

    def to_utc(self, from_timezone: str):
        tz = _parse_tz(from_timezone)

        def fun(v):
            return v.replace(tzinfo=tz).astimezone(datetime.timezone.utc)

        return self._call("to_utc", fun, return_type=dt.DATE_TIME_UTC)

    def to_naive_in_timezone(self, timezone: str):
        tz = _parse_tz(timezone)

        def fun(v):
            return v.astimezone(tz).replace(tzinfo=None)

        return self._call(
            "to_naive_in_timezone", fun, return_type=dt.DATE_TIME_NAIVE
        )

    def utc_from_timestamp(self, unit: str = "s"):
        div = {"ns": 1e9, "us": 1e6, "ms": 1e3, "s": 1.0}[unit]

        def fun(v):
            return datetime.datetime.fromtimestamp(v / div, tz=datetime.timezone.utc)

        return self._call("utc_from_timestamp", fun, return_type=dt.DATE_TIME_UTC)

    def from_timestamp(self, unit: str = "s"):
        div = {"ns": 1e9, "us": 1e6, "ms": 1e3, "s": 1.0}[unit]

        def fun(v):
            return datetime.datetime(1970, 1, 1) + datetime.timedelta(seconds=v / div)

        return self._call("from_timestamp", fun, return_type=dt.DATE_TIME_NAIVE)

    def round(self, duration):
        def fun(v, d):
            d = _as_timedelta(d)
            epoch = _epoch_like(v)
            n = (v - epoch) / d
            return epoch + round(n) * d

        return self._call("round", fun, smart_wrap(duration))

    def floor(self, duration):
        def fun(v, d):
            d = _as_timedelta(d)
            epoch = _epoch_like(v)
            n = int((v - epoch) // d)
            return epoch + n * d

        return self._call("floor", fun, smart_wrap(duration))

    def weekday(self):
        return self._call("weekday", lambda v: v.weekday(), return_type=dt.INT)

    # duration accessors ---------------------------------------------------
    def nanoseconds(self):
        return self._call(
            "nanoseconds",
            lambda v: int(v.total_seconds() * 1e9),
            return_type=dt.INT,
        )

    def microseconds(self):
        return self._call(
            "microseconds",
            lambda v: int(v.total_seconds() * 1e6),
            return_type=dt.INT,
        )

    def milliseconds(self):
        return self._call(
            "milliseconds",
            lambda v: int(v.total_seconds() * 1e3),
            return_type=dt.INT,
        )

    def seconds(self):
        return self._call(
            "seconds", lambda v: int(v.total_seconds()), return_type=dt.INT
        )

    def minutes(self):
        return self._call(
            "minutes", lambda v: int(v.total_seconds() // 60), return_type=dt.INT
        )

    def hours(self):
        return self._call(
            "hours", lambda v: int(v.total_seconds() // 3600), return_type=dt.INT
        )

    def days(self):
        return self._call("days", lambda v: v.days, return_type=dt.INT)

    def weeks(self):
        return self._call("weeks", lambda v: v.days // 7, return_type=dt.INT)


def _epoch_like(v: datetime.datetime) -> datetime.datetime:
    if v.tzinfo is None:
        return datetime.datetime(1970, 1, 1)
    return datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)


def _as_timedelta(d) -> datetime.timedelta:
    if isinstance(d, datetime.timedelta):
        return d
    raise TypeError(f"expected Duration, got {type(d)}")
