"""Hidden-Markov-Model decoding as a custom reducer (reference:
python/pathway/stdlib/ml/hmm.py create_hmm_reducer:11 — Viterbi over a
networkx DiGraph, folded observation-by-observation inside a
BaseCustomAccumulator).

The graph contract matches the reference:
  * `graph.graph["start_nodes"]`: iterable of start states;
  * each node carries `idx` (dense int) and `calc_emission_log_ppb(obs)`;
  * each edge carries `log_transition_ppb`.
"""

from __future__ import annotations

from collections import deque
from typing import Any

import numpy as np

from pathway_tpu_torch.internals.reducers import BaseCustomAccumulator, udf_reducer


def create_hmm_reducer(
    graph,
    beam_size: int | None = None,
    num_results_kept: int | None = None,
):
    """Returns a reducer decoding the most likely state path for the
    observations aggregated (in order) into each group."""
    idx_to_node = {graph.nodes[n]["idx"]: n for n in graph.nodes}
    n_nodes = graph.number_of_nodes()
    effective_beam = beam_size if beam_size is not None else n_nodes + 1

    class HmmAccumulator(BaseCustomAccumulator):
        def __init__(self, observation):
            self.cnt = 1
            self.observation = observation
            self.ppb = np.full(n_nodes, -np.inf)
            self.backpointers: deque[np.ndarray] = deque()
            self.trimmed_nodes_idx = []
            for start_node in graph.graph["start_nodes"]:
                idx = graph.nodes[start_node]["idx"]
                self.ppb[idx] = graph.nodes[start_node][
                    "calc_emission_log_ppb"
                ](observation)
                self.trimmed_nodes_idx.append(idx)
            self.path_states = (idx_to_node[int(self.ppb.argmax())],)

        @classmethod
        def from_row(cls, row):
            (observation,) = row
            return cls(observation)

        def update(self, other) -> None:
            assert other.cnt == 1, "HMM accumulator folds one row at a time"
            self.cnt += 1
            observation = other.observation
            new_ppb = np.full(n_nodes, -np.inf)
            new_backpointers = np.zeros(n_nodes, dtype=int)
            reachable: dict = {}
            for start_idx in self.trimmed_nodes_idx:
                start_node = idx_to_node[start_idx]
                cost = self.ppb[start_idx]
                for node in graph.successors(start_node):
                    step = cost + graph.get_edge_data(start_node, node)[
                        "log_transition_ppb"
                    ]
                    reachable.setdefault(node, []).append((step, start_idx))
            trimmed = []
            for node, candidates in reachable.items():
                emission = graph.nodes[node]["calc_emission_log_ppb"](
                    observation
                )
                best_cost, best_from = max(candidates)
                idx = graph.nodes[node]["idx"]
                new_ppb[idx] = emission + best_cost
                new_backpointers[idx] = best_from
                trimmed.append(idx)
            if len(trimmed) > effective_beam:
                trimmed.sort(key=lambda i: -new_ppb[i])
                kept = set(trimmed[:effective_beam])
                for i in trimmed[effective_beam:]:
                    new_ppb[i] = -np.inf
                trimmed = [i for i in trimmed if i in kept]
            self.ppb = new_ppb
            self.backpointers.append(new_backpointers)
            self.trimmed_nodes_idx = trimmed
            # decode best path via backpointers
            best = int(self.ppb.argmax())
            path = [best]
            for bp in reversed(self.backpointers):
                path.append(int(bp[path[-1]]))
            path.reverse()
            states = tuple(idx_to_node[i] for i in path)
            if num_results_kept is not None:
                states = states[-num_results_kept:]
            self.path_states = states

        def compute_result(self) -> tuple:
            return self.path_states

    return udf_reducer(HmmAccumulator)
