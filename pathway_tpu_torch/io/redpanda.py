"""pw.io.redpanda — Redpanda connector (reference: python/pathway/io/redpanda
— Kafka-protocol compatible; read:19, write:197 delegate to the Kafka
machinery)."""

from __future__ import annotations

from pathway_tpu_torch.io.kafka import read, simple_read, write

__all__ = ["read", "simple_read", "write"]
