"""pw.io.slack — Slack alert sink (reference: python/pathway/io/slack
send_alerts:11 — posts each new value of a column to a Slack channel via
chat.postMessage). Functional via `requests`.
"""

from __future__ import annotations

from typing import Sequence

from pathway_tpu_torch.io._writer import OutputWriter, RowEvent, attach_writer, jsonable

_SLACK_URL = "https://slack.com/api/chat.postMessage"


class _SlackWriter(OutputWriter):
    def __init__(self, column: str, channel_id: str, token: str, *, _post=None):
        self.column = column
        self.channel_id = channel_id
        self.token = token
        if _post is None:
            import requests

            _post = requests.post
        self._post = _post

    def write_batch(self, events: Sequence[RowEvent]) -> None:
        for ev in events:
            if ev.diff <= 0:
                continue  # alerts fire on additions only
            self._post(
                _SLACK_URL,
                json={
                    "channel": self.channel_id,
                    "text": str(jsonable(ev.values[self.column])),
                },
                headers={"Authorization": f"Bearer {self.token}"},
            )


def send_alerts(
    alerts, slack_channel_id: str, slack_token: str, *, _post=None
) -> None:
    """Post each new value of `alerts` (a ColumnReference) to Slack
    (reference: io/slack send_alerts:11)."""
    table = alerts.table.select(**{alerts.name: alerts})
    attach_writer(
        table,
        _SlackWriter(alerts.name, slack_channel_id, slack_token, _post=_post),
    )
