"""The served side of a RAG cell: a recorder around the chat model the
benchmark hands to `HFPipelineChat`, and closed-loop HTTP clients.

The recorder notes each generate call's host interval (also as a
`bench.generate` span on the profiler's clock), its prompts and the
token ids of its answers, taken where the chat model renders them
(its tokenizer's `decode`), in the thread that made the call.
"""

from __future__ import annotations

import threading
import time
import urllib.error
import urllib.request


class _RecordingTokenizer:
    def __init__(self, inner, local):
        self._inner, self._local = inner, local

    def decode(self, ids):
        rows = getattr(self._local, "rows", None)
        if rows is not None:
            rows.append([int(i) for i in ids])
        return self._inner.decode(ids)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class GenerateRecorder:
    """Stands in for the chat model as HFPipelineChat's `generator=`."""

    def __init__(self, chat):
        self.inner = chat
        self.calls: list = []
        self.started: list = []  # prompts of each call, as it begins
        self._lock = threading.Lock()
        self._local = threading.local()
        chat.tokenizer = _RecordingTokenizer(chat.tokenizer, self._local)

    def generate(self, prompts, *, max_new_tokens: int = 16, temperature: float = 0.0):
        from torch.profiler import record_function

        self._local.rows = []
        with self._lock:
            self.started.append(len(prompts))
        t0 = time.perf_counter()
        try:
            with record_function("bench.generate"):
                out = self.inner.generate(prompts, max_new_tokens=max_new_tokens,
                                          temperature=temperature)
        finally:
            rows, self._local.rows = self._local.rows, None
        t1 = time.perf_counter()
        with self._lock:
            self.calls.append({"t0": t0, "t1": t1, "prompts": list(prompts), "rows": rows,
                               "texts": list(out)})
        return out

    def finished(self) -> int:
        with self._lock:
            return len(self.calls)


class ClosedLoop:
    """`clients` threads, each sending its questions one after another
    with no think time, until `stop_sending`."""

    def __init__(self, run, url: str, questions: list, timeout: float):
        self.run, self.url, self.timeout = run, url, timeout
        self.questions = questions
        self.records: list = []
        self._lock = threading.Lock()
        self.stop_sending = threading.Event()
        self.threads: list = []
        # the server is on this host: never through a proxy that the
        # environment may name (http_proxy without 127.0.0.1 in no_proxy)
        self._opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))

    def start(self, clients) -> None:
        """Start these clients (indices into `questions`)."""
        self.threads += [self.run.thread(f"client-{c}", self._client, c) for c in clients]

    def _ask(self, question: str):
        """One /v2/answer: (reply, error)."""
        import json

        body = json.dumps({"prompt": question, "filters": None, "model": None,
                           "return_context_docs": True}).encode()
        req = urllib.request.Request(self.url + "/v2/answer", data=body,
                                     headers={"Content-Type": "application/json"}, method="POST")
        try:
            with self._opener.open(req, timeout=self.timeout) as resp:
                return json.loads(resp.read()), None
        except (urllib.error.URLError, OSError, ValueError) as exc:
            return None, repr(exc)

    def pilot(self, question: str, deadline: float) -> None:
        """One question outside the records, to occupy the server; asked
        again until the server answers (it may not listen yet)."""
        while self._ask(question)[0] is None and time.perf_counter() < deadline:
            time.sleep(0.2)

    def _client(self, c: int) -> None:
        for q in self.questions[c]:
            if self.stop_sending.is_set() or self.run.stop.is_set():
                return
            record = {"client": c, "question": q, "t_send": time.perf_counter(), "t_recv": None,
                      "reply": None, "error": None}
            with self._lock:
                self.records.append(record)
            reply, error = self._ask(q)
            with self._lock:
                record.update(t_recv=time.perf_counter(), reply=reply, error=error)
        raise RuntimeError(f"client {c} ran out of questions")

    def done(self) -> bool:
        return all(not t.is_alive() for t in self.threads)

    def snapshot(self) -> list:
        """Copies of the records; t_recv is None for an answer in flight."""
        with self._lock:
            return [dict(r) for r in self.records]
