"""pw.temporal — windows, temporal joins, behaviors (reference:
python/pathway/stdlib/temporal/)."""

from pathway_tpu_torch.stdlib.temporal._window import (
    Window,
    intervals_over,
    session,
    sliding,
    tumbling,
    windowby,
)
from pathway_tpu_torch.stdlib.temporal.temporal_behavior import (
    Behavior,
    CommonBehavior,
    ExactlyOnceBehavior,
    common_behavior,
    exactly_once_behavior,
)
from pathway_tpu_torch.stdlib.temporal._interval_join import (
    Interval,
    IntervalJoinResult,
    interval,
    interval_join,
    interval_join_inner,
    interval_join_left,
    interval_join_outer,
    interval_join_right,
)
from pathway_tpu_torch.stdlib.temporal._asof_join import (
    AsofJoinResult,
    Direction,
    asof_join,
    asof_join_inner,
    asof_join_left,
    asof_join_outer,
    asof_join_right,
)
from pathway_tpu_torch.stdlib.temporal._asof_now_join import (
    AsofNowJoinResult,
    asof_now_join,
    asof_now_join_inner,
    asof_now_join_left,
)
from pathway_tpu_torch.stdlib.temporal._window_join import (
    WindowJoinResult,
    window_join,
    window_join_inner,
    window_join_left,
    window_join_outer,
    window_join_right,
)
from pathway_tpu_torch.stdlib.temporal.time_utils import (
    inactivity_detection,
    utc_now,
)

__all__ = [
    "Interval",
    "AsofNowJoinResult",
    "IntervalJoinResult",
    "WindowJoinResult",
    "Window",
    "windowby",
    "tumbling",
    "sliding",
    "session",
    "intervals_over",
    "Behavior",
    "CommonBehavior",
    "ExactlyOnceBehavior",
    "common_behavior",
    "exactly_once_behavior",
    "interval",
    "interval_join",
    "interval_join_inner",
    "interval_join_left",
    "interval_join_right",
    "interval_join_outer",
    "asof_join",
    "asof_join_inner",
    "asof_join_left",
    "asof_join_right",
    "asof_join_outer",
    "asof_now_join",
    "asof_now_join_inner",
    "asof_now_join_left",
    "window_join",
    "window_join_inner",
    "window_join_left",
    "window_join_right",
    "window_join_outer",
    "inactivity_detection",
    "utc_now",
]
