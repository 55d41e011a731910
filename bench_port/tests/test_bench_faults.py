"""`correct` comes out false when the timed path is broken underneath:
faults planted in the program, each cell driven on the CPU at a toy size
past the harness's look for a card. A fault each of the kinds a serving
cell can have: an answer altered where it is produced, half of a batch
left out with the rest's mean in its place, a step that leaves its state
unchanged. (One chip: no exchange between chips to leave out.)"""

from __future__ import annotations

import pytest
import torch

from bench_port.tests import toy


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy.toy_tree(str(tmp_path_factory.mktemp("toy")))


def ingest_fault(kind: str):
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex

    original = DeviceKnnIndex.add_batch

    def add_batch(self, keys, vectors, shards=None):
        if torch.is_tensor(vectors) and len(keys) > 1:
            vectors = vectors.clone()
            n = vectors.shape[0]
            if kind == "altered":
                vectors[0, 0] += 0.5
            elif kind == "half_batch":
                vectors[n // 2:] = vectors[: n // 2].mean(dim=0)
            elif kind == "state_unchanged":
                for k in keys:  # slots taken, the rows never written
                    self._assign_slot(k)
                return None
        return original(self, keys, vectors, shards)

    return DeviceKnnIndex, "add_batch", add_batch


def decoder_fault(kind: str):
    from pathway_tpu_torch.models import decoder_lm

    original = decoder_lm.generate_tokens

    def generate_tokens(*args, **kwargs):
        toks = original(*args, **kwargs).copy()
        if kind == "altered":
            toks[:, 1] = (toks[:, 1] + 1) % 1000
        elif kind == "half_batch":
            toks[toks.shape[0] // 2:] = toks[0]
        elif kind == "state_unchanged":
            toks[:] = toks[:, :1]
        return toks

    return decoder_lm, "generate_tokens", generate_tokens


@pytest.mark.parametrize("kind", ["altered", "half_batch", "state_unchanged"])
@pytest.mark.parametrize("workload,fault", [("toy-ingest", ingest_fault), ("toy-rag", decoder_fault)])
def test_a_broken_path_is_not_correct(root, monkeypatch, workload, fault, kind):
    monkeypatch.setattr(*fault(kind))
    result = toy.drive(root, workload, seed=1234)
    assert result["correct"] is False, result["checks"]
