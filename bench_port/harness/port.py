"""The system under test, built from a configuration file: the port's
DocumentStore over its fused index and sentence encoder, and its chat
model. Everything of `pathway_tpu_torch` the drivers use is reached
from here or from the drivers themselves; nothing imports the JAX
package.
"""

from __future__ import annotations

import queue
import time

from bench_port.harness import weights
from bench_port.harness.core import BenchFailure


def encoder_config(cfg: dict):
    from pathway_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(
        vocab_size=cfg["vocab_size"], hidden=cfg["hidden_size"], layers=cfg["num_hidden_layers"],
        heads=cfg["num_attention_heads"], mlp_dim=cfg["intermediate_size"],
        max_len=cfg["max_position_embeddings"], pooling=cfg["pooling"], dtype=cfg["torch_dtype"],
        norm_style="post",
    )


def embedder(cfg: dict, seed: int, device: str):
    """SentenceTransformerEmbedder with the BERT layout, its weights the
    benchmark's own draw from `seed`."""
    from pathway_tpu_torch.models.transformer import TransformerLM
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    tc = encoder_config(cfg)
    emb = SentenceTransformerEmbedder(cfg["model_name"], config=tc, max_len=cfg["max_seq_length"],
                                      device=device)
    emb.encoder.lm = TransformerLM(tc, params=weights.encoder_tree(seed, cfg, device), device=device)
    return emb


def document_store(docs, cfg: dict, seed: int, device: str):
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import BruteForceKnnFactory
    from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore

    index = cfg["index"]
    factory = BruteForceKnnFactory(dimensions=index["dimensions"], reserved_space=index["reserved_space"],
                                   embedder=embedder(cfg, seed, device))
    return DocumentStore(docs, retriever_factory=factory)


def decoder_config(cfg: dict):
    from pathway_tpu_torch.models.decoder import DecoderConfig

    return DecoderConfig(
        vocab_size=cfg["vocab_size"], hidden=cfg["hidden_size"], layers=cfg["num_hidden_layers"],
        q_heads=cfg["num_attention_heads"], kv_heads=cfg["num_key_value_heads"],
        mlp_dim=cfg["intermediate_size"], max_len=cfg["serving"]["max_len"],
        rope_theta=cfg["rope_theta"], norm_eps=cfg["rms_norm_eps"], dtype=cfg["torch_dtype"],
    )


def chat_model(cfg: dict, seed: int, device: str):
    """ChatModel at the configuration's geometry, its weights then
    replaced by the benchmark's own draw from `seed`."""
    from pathway_tpu_torch.models.decoder_lm import ChatModel

    chat = ChatModel(cfg["model_name"], config=decoder_config(cfg), max_len=cfg["serving"]["max_len"],
                     device=device)
    chat.params = None
    chat.params = weights.decoder_tree(seed, cfg, device)
    return chat


def jsonlines_docs(path: str, poll_s: float):
    import pathway_tpu_torch as pw

    return pw.io.jsonlines.read(path, schema=pw.schema_from_types(data=str), mode="streaming",
                                batch_per_file=True, refresh_interval=poll_s)


def index_impls(engine) -> list:
    from pathway_tpu_torch.engine.index_node import ExternalIndexNode

    return [n.index for n in engine.nodes if isinstance(n, ExternalIndexNode)]


def index_nodes(engine) -> list:
    from pathway_tpu_torch.engine.index_node import ExternalIndexNode

    return [n for n in engine.nodes if isinstance(n, ExternalIndexNode)]


def running_engine(run, deadline: float):
    """The engine of the run in progress, once it has built its nodes."""
    from pathway_tpu_torch.internals import runner

    def ready():
        eng = runner.last_engine()
        return eng if eng is not None and index_nodes(eng) else None

    return run.wait_until(ready, deadline, "the engine's index nodes")


def stop_engine(engine, thread, deadline: float) -> None:
    from pathway_tpu_torch.internals import runner

    engine.terminate_flag.set()
    thread.join(timeout=max(0.0, deadline - time.perf_counter()))
    if thread.is_alive():
        raise BenchFailure("the engine did not stop within its deadline")
    runner._last_engine = None


class QuerySubject:
    """A python connector subject fed from a queue (None ends it)."""

    def __init__(self):
        import pathway_tpu_torch as pw

        self.q: queue.Queue = queue.Queue()
        feed = self.q

        class Subject(pw.io.python.ConnectorSubject):
            def run(self) -> None:
                while True:
                    item = feed.get()
                    if item is None:
                        return
                    self.next(**item)
                    self.commit()

        self.subject = Subject()


def health_actions(since: dict | None = None) -> dict:
    """pathway_health_actions_total by action; with `since`, the actions
    taken after it."""
    from pathway_tpu_torch.internals import health

    now = dict(health.controller().status()["actions"])
    if since is None:
        return now
    return {k: v - since.get(k, 0) for k, v in now.items() if v != since.get(k, 0)}


def release() -> None:
    """Drop the program's model caches and free its device memory."""
    import gc

    import torch

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.models import decoder_lm, minilm

    minilm._model_cache.clear()
    decoder_lm._model_cache.clear()
    pw.G.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
