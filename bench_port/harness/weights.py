"""Random weights from the run's seed, made on the device in a few large
draws, handed to the program and, drawn again after the program's state
is freed, to the reference.

The trees use the port's layout and key names (dense weights [in, out]),
which is also what the reference reads. Dense weights and biases are
N(0, 0.02); norm scales are one and norm biases zero, as a fresh
checkpoint is initialised. A draw on the same device with the same seed
gives the same values, so the reference works the weights out again
rather than taking the program's.
"""

from __future__ import annotations

import torch

from bench_port.harness.textgen import subseed

STD = 0.02


def _draw(seed: int, parts: tuple, shapes: dict, device, dtype) -> dict:
    """One normal draw split into tensors of `shapes` (contiguous views)."""
    sizes = [torch.Size(s).numel() for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(subseed(seed, *parts))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    flat.mul_(STD)
    flat = flat.to(dtype)
    out, at = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        out[name] = flat[at : at + n].view(shape)
        at += n
    return out


def encoder_dims(cfg: dict) -> dict:
    return {"v": cfg["vocab_size"], "h": cfg["hidden_size"], "mlp": cfg["intermediate_size"],
            "layers": cfg["num_hidden_layers"], "pos": cfg["max_position_embeddings"],
            "types": cfg["type_vocab_size"]}


def encoder_tree(seed: int, cfg: dict, device) -> dict:
    """A BERT-layout (post-LN) encoder in f32: word, position and type
    embeddings with their LayerNorm, then per layer qkv, out, ln1, up,
    down, ln2."""
    d = encoder_dims(cfg)
    h, mlp = d["h"], d["mlp"]
    ones = lambda: torch.ones(h, device=device)  # noqa: E731
    zeros = lambda: torch.zeros(h, device=device)  # noqa: E731
    emb = _draw(seed, ("encoder", "embed"),
                {"embed": (d["v"], h), "pos_embed": (d["pos"], h), "type_embed": (d["types"], h)},
                device, torch.float32)
    tree = dict(emb, embed_ln={"scale": ones(), "bias": zeros()},
                ln_f={"scale": ones(), "bias": zeros()}, layers=[])
    for i in range(d["layers"]):
        layer = _draw(seed, ("encoder", "layer", i),
                      {"qkv": (h, 3 * h), "qkv_b": (3 * h,), "out": (h, h), "out_b": (h,),
                       "up": (h, mlp), "up_b": (mlp,), "down": (mlp, h), "down_b": (h,)},
                      device, torch.float32)
        layer["ln1"] = {"scale": ones(), "bias": zeros()}
        layer["ln2"] = {"scale": ones(), "bias": zeros()}
        tree["layers"].append(layer)
    return tree


def decoder_dims(cfg: dict) -> dict:
    h, q = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"v": cfg["vocab_size"], "h": h, "kv": cfg["num_key_value_heads"] * (h // q),
            "mlp": cfg["intermediate_size"], "layers": cfg["num_hidden_layers"]}


def decoder_dtype(cfg: dict) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["torch_dtype"]]


def decoder_layer(seed: int, cfg: dict, i: int, device) -> dict:
    """Layer i of a Mistral-layout decoder in its served dtype."""
    d = decoder_dims(cfg)
    h, kv, mlp = d["h"], d["kv"], d["mlp"]
    layer = _draw(seed, ("decoder", "layer", i),
                  {"wq": (h, h), "wk": (h, kv), "wv": (h, kv), "wo": (h, h),
                   "gate": (h, mlp), "up": (h, mlp), "down": (mlp, h)},
                  device, decoder_dtype(cfg))
    layer["ln1"] = torch.ones(h, device=device)
    layer["ln2"] = torch.ones(h, device=device)
    return layer


def decoder_head(seed: int, cfg: dict, device) -> dict:
    """The embedding, the untied output head and the final norm."""
    d = decoder_dims(cfg)
    out = _draw(seed, ("decoder", "head"), {"embed": (d["v"], d["h"]), "lm_head": (d["v"], d["h"])},
                device, decoder_dtype(cfg))
    out["ln_f"] = torch.ones(d["h"], device=device)
    return out


def decoder_tree(seed: int, cfg: dict, device) -> dict:
    tree = decoder_head(seed, cfg, device)
    tree["layers"] = [decoder_layer(seed, cfg, i, device) for i in range(cfg["num_hidden_layers"])]
    return tree
