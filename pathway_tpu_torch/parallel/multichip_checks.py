"""Multichip parity checks (counterpart of
pathway_tpu/parallel/multichip_checks.py).

The JAX package's four checks of its mesh, on the port's single-controller
mesh: a sharded train step over ("dp", "tp"), the sequence-parallel ring
forward over "sp", tensor-parallel KV-cached decode, and retrieval through
the engine over a row-sharded KNN index, held exactly (`==`) to the
single-device answer. The JAX checks take the process's devices; each of
these takes `devices=`, a list of at least n_devices torch devices that
may repeat one (`["cuda:0"] * 4` on one card, `["cpu"] * 8` in the tests),
and None means the first n_devices CUDA devices.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def _dp_tp(n_devices: int) -> Tuple[int, int]:
    tp = 2 if n_devices % 2 == 0 else 1
    return n_devices // tp, tp


def _mesh(shape, names, n_devices: int, devices: Optional[Sequence]):
    import torch

    from pathway_tpu_torch.parallel.mesh import get_mesh

    if devices is None:
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(
                f"{n_devices} CUDA devices needed, {torch.cuda.device_count()} attached; "
                "pass devices= (e.g. ['cuda:0'] * n) to lay the mesh over fewer"
            )
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    return get_mesh(shape, names, devices=list(devices)[:n_devices])


def check_sharded_train_step(n_devices: int, devices: Optional[Sequence] = None) -> float:
    """One real optimizer step over a ("dp","tp") mesh: params
    tensor-parallel over 'tp' (Megatron qkv/up column, out/down row),
    batch data-parallel over 'dp'. Returns the (finite) loss."""
    import torch

    from pathway_tpu_torch.models.tokenizer import HashTokenizer, encode_batch
    from pathway_tpu_torch.models.training import make_sharded_train_step
    from pathway_tpu_torch.models.transformer import TransformerConfig, init_params

    dp, tp = _dp_tp(n_devices)
    config = TransformerConfig(
        vocab_size=512,
        hidden=64,
        layers=2,
        heads=4,
        mlp_dim=128,
        max_len=32,
        causal=True,
        pooling="none",
    )
    mesh = _mesh((dp, tp), ("dp", "tp"), n_devices, devices)
    params = init_params(torch.Generator().manual_seed(0), config)
    tokenizer = HashTokenizer(vocab_size=config.vocab_size)
    texts = [f"sample document number {i}" for i in range(dp * 4)]
    ids, mask = encode_batch(tokenizer, texts, max_len=32, batch_bucket=False)
    labels = np.roll(ids, -1, axis=1)

    step, place_params, place_batch = make_sharded_train_step(mesh, config)
    shards = place_params(params)
    ids_d, mask_d, labels_d = place_batch(
        ids.astype(np.int64), mask.astype(np.int64), labels.astype(np.int64)
    )
    _new_shards, loss = step(shards, ids_d, mask_d, labels_d)
    loss = float(loss)
    assert np.isfinite(loss), f"non-finite loss: {loss}"
    return loss


def check_sp_ring(n_devices: int, devices: Optional[Sequence] = None) -> Tuple[int, ...]:
    """Sequence parallelism: full forward with ring attention over an
    'sp' axis spanning every device (exact attention, KV chunks rotating
    via ppermute). Returns the logits shape."""
    import torch

    from pathway_tpu_torch.models.long_context import sequence_parallel_forward
    from pathway_tpu_torch.models.transformer import TransformerConfig, init_params

    sp_mesh = _mesh((n_devices,), ("sp",), n_devices, devices)
    sp_len = 8 * n_devices
    # ring attention does not shard heads, so heads need not relate to
    # n_devices — 4 divides hidden=64 for any device count
    sp_config = TransformerConfig(
        vocab_size=512, hidden=64, layers=2, heads=4,
        mlp_dim=128, max_len=sp_len, causal=True, pooling="none",
    )
    sp_params = init_params(torch.Generator().manual_seed(1), sp_config)
    # exact-length batch (the sp axis needs L divisible by n_devices)
    sp_rng = np.random.default_rng(0)
    sp_ids = sp_rng.integers(0, sp_config.vocab_size, size=(2, sp_len)).astype(np.int32)
    sp_mask = np.ones((2, sp_len), dtype=np.int32)
    logits = sequence_parallel_forward(
        sp_params, sp_config, sp_ids, sp_mask, sp_mesh, attn="ring"
    )
    assert bool(torch.isfinite(logits).all())
    return tuple(logits.shape)


def check_tp_decode(n_devices: int, devices: Optional[Sequence] = None) -> Tuple[int, ...]:
    """KV-cached decoder generation with Megatron TP shardings over
    'tp'. Returns the generated-token shape."""
    import torch

    from pathway_tpu_torch.models.decoder import (
        DecoderConfig,
        decoder_tp_split,
        generate_tokens,
        init_decoder_params,
    )

    dp, tp = _dp_tp(n_devices)
    mesh = _mesh((dp, tp), ("dp", "tp"), n_devices, devices)
    dec_config = DecoderConfig(
        vocab_size=256, hidden=64, layers=2, q_heads=4 * tp,
        kv_heads=2 * tp, mlp_dim=128, max_len=64, dtype="float32",
    )
    dec_params = init_decoder_params(
        torch.Generator().manual_seed(2), dec_config, device=mesh.devices.flat[0]
    )
    shards = decoder_tp_split(dec_params, dec_config, mesh)
    toks = generate_tokens(
        shards, dec_config,
        np.ones((dp * 2, 8), dtype=np.int32),
        np.ones((dp * 2, 8), dtype=np.int32),
        max_new_tokens=4,
    )
    assert toks.shape == (dp * 2, 4)
    return tuple(toks.shape)


def check_sharded_retrieval_parity(
    n_devices: int, devices: Optional[Sequence] = None
) -> Tuple[list, int]:
    """FRAMEWORK path on the mesh: DocumentStore ingest ->
    DeviceKnnIndex(mesh) -> sharded search (per-shard top-k through the
    knn_topk kernel + a merge of the gathered candidates) ->
    retrieve_query THROUGH THE ENGINE, asserting EXACT parity with the
    dense single-device result (the embeddings are identical — only the
    search is sharded — so the comparison is `==`, not allclose).
    Returns (results, n_docs)."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.runner import run_tables
    from pathway_tpu_torch.models.transformer import TransformerConfig
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import (
        BruteForceKnnFactory,
    )
    from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    tiny_cfg = TransformerConfig(
        vocab_size=256, hidden=32, layers=1, heads=2, mlp_dim=64,
        max_len=32, dtype="float32",
    )
    n_docs = n_devices * 3
    reserved = n_devices * 4
    doc_rows = [(f"tiny doc number {i} alpha{i % 5}",) for i in range(n_docs)]
    knn_mesh = _mesh((n_devices,), ("knn",), n_devices, devices)
    embedder = SentenceTransformerEmbedder(
        "dryrun-tiny", config=tiny_cfg, max_len=16, seed=5,
        device=knn_mesh.devices.flat[0],
    )

    def retrieve(mesh_arg):
        pw.G.clear()
        docs_t = pw.debug.table_from_rows(
            pw.schema_from_types(data=str), list(doc_rows)
        )
        factory = BruteForceKnnFactory(
            dimensions=embedder.get_embedding_dimension(),
            embedder=embedder,
            reserved_space=reserved,
            mesh=mesh_arg,
        )
        store = DocumentStore(docs_t, retriever_factory=factory)
        queries = pw.debug.table_from_rows(
            pw.schema_from_types(
                query=str, k=int, metadata_filter=str,
                filepath_globpattern=str,
            ),
            [(f"tiny doc number {q} alpha{q % 5}", 3, None, None)
             for q in (1, n_docs - 1)],
        )
        results = store.retrieve_query(queries)
        (cap,) = run_tables(results)
        out = []
        for (res,) in sorted(cap.state.rows.values(), key=repr):
            out.append(
                [d["text"] for d in res.value]
                if hasattr(res, "value")
                else res
            )
        return out

    dense_results = retrieve(None)
    sharded_results = retrieve(knn_mesh)
    assert dense_results == sharded_results, (
        dense_results,
        sharded_results,
    )
    assert dense_results and all(r for r in dense_results)
    # a probe document retrieves itself through both paths
    flat_hits = {h for hits in dense_results for h in hits}
    assert "tiny doc number 1 alpha1" in flat_hits, dense_results
    return sharded_results, n_docs


def run_all(n_devices: int, devices: Optional[Sequence] = None) -> dict:
    """Every check in the JAX package's order; returns the summary facts
    its report line prints."""
    dp, tp = _dp_tp(n_devices)
    loss = check_sharded_train_step(n_devices, devices)
    sp_shape = check_sp_ring(n_devices, devices)
    tok_shape = check_tp_decode(n_devices, devices)
    sharded_results, n_docs = check_sharded_retrieval_parity(n_devices, devices)
    mesh = _mesh((dp, tp), ("dp", "tp"), n_devices, devices)
    return {
        "mesh": dict(zip(mesh.axis_names, mesh.devices.shape)),
        "loss": loss,
        "sp_ring_logits": sp_shape,
        "tp_decode": tok_shape,
        "retrieval_queries": len(sharded_results),
        "n_docs": n_docs,
        "n_devices": n_devices,
    }
