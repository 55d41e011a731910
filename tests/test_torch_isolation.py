"""The port stands alone: no file of pathway_tpu_torch/, chip_smoke.py,
trace_port.py or tests/test_torch_cuda.py imports JAX or the JAX package,
and its entry
points refuse to run on the CPU unless asked to."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "pathway_tpu_torch")


def _port_files():
    # the card tests run on a machine without JAX, so they are held to the
    # same rule
    out = [
        os.path.join(REPO, name)
        for name in ("chip_smoke.py", "trace_port.py", os.path.join("tests", "test_torch_cuda.py"))
    ]
    for root, _dirs, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(os.path.relpath(p, REPO) for p in out)


def _forbidden(module: str) -> bool:
    # match the module `pathway_tpu` exactly or a submodule of it, never
    # the `pathway_tpu_torch` prefix
    return any(
        module == name or module.startswith(name + ".") for name in ("jax", "jaxlib", "pathway_tpu")
    )


def _imports(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None)) in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            yield str(node.args[0].value)


def test_forbidden_matches_the_module_not_the_prefix():
    assert _forbidden("pathway_tpu") and _forbidden("pathway_tpu.ops.knn")
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert not _forbidden("pathway_tpu_torch.ops.knn") and not _forbidden("jaxtyping")


@pytest.mark.parametrize("path", _port_files())
def test_port_file_imports_neither_jax_nor_the_jax_package(path):
    with open(os.path.join(REPO, path), encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    bad = [m for m in _imports(tree) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import pathway_tpu_torch.ops.knn, pathway_tpu_torch.models.minilm\n"
        "import pathway_tpu_torch.models.hf_loader, pathway_tpu_torch.models.convert\n"
        "import pathway_tpu_torch.models.decoder, pathway_tpu_torch.models.decoder_lm\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'pathway_tpu' or m.startswith('pathway_tpu.'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny_config():
    from pathway_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(vocab_size=64, hidden=16, layers=1, heads=2, mlp_dim=32, max_len=16)


@pytest.mark.parametrize(
    "entry",
    [
        "resolve_device", "TransformerLM", "SentenceEncoder", "DeviceKnnIndex",
        "FusedEmbedSearch", "ChatModel",
    ],
)
def test_entry_points_raise_without_cuda(no_cuda, entry):
    from pathway_tpu_torch import resolve_device
    from pathway_tpu_torch.models.decoder_lm import ChatModel
    from pathway_tpu_torch.models.minilm import SentenceEncoder
    from pathway_tpu_torch.models.transformer import TransformerLM
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex, FusedEmbedSearch

    make = {
        "resolve_device": lambda: resolve_device(None),
        "TransformerLM": lambda: TransformerLM(_tiny_config()),
        "SentenceEncoder": lambda: SentenceEncoder("iso", config=_tiny_config()),
        "DeviceKnnIndex": lambda: DeviceKnnIndex(16),
        # CPU parts, but no device named for the fused object itself
        "FusedEmbedSearch": lambda: FusedEmbedSearch(
            SentenceEncoder("iso", config=_tiny_config(), device="cpu"),
            DeviceKnnIndex(16, device="cpu"),
        ),
        "ChatModel": lambda: ChatModel("tiny-decoder"),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        make()


def test_entry_points_run_on_the_cpu_when_asked(no_cuda):
    from pathway_tpu_torch.models.minilm import SentenceEncoder
    from pathway_tpu_torch.ops.knn import DeviceKnnIndex, FusedEmbedSearch

    enc = SentenceEncoder("iso", config=_tiny_config(), device="cpu")
    fused = FusedEmbedSearch(enc, DeviceKnnIndex(16, device="cpu"), device="cpu")
    fused.embed_and_add(["a", "b"], ["first doc", "second doc"])
    assert fused.search_texts(["first doc"], 1)[0][0][0] == "a"
    assert enc.device.type == fused.index.device.type == "cpu"


def test_chat_model_runs_on_the_cpu_when_asked(no_cuda):
    from pathway_tpu_torch.models.decoder_lm import ChatModel

    chat = ChatModel("tiny-decoder", device="cpu")
    out = chat.generate(["hello world", "stream processing"], max_new_tokens=3)
    assert len(out) == 2 and all(isinstance(s, str) for s in out)
    assert chat.device.type == chat.params["embed"].device.type == "cpu"
