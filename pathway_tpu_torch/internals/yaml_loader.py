"""YAML app loader: `$`-tagged object instantiation + variables for
declarative RAG apps (reference: python/pathway/internals/yaml_loader.py
:74-232). Example::

    $embedder: !pw.xpacks.llm.embedders.SentenceTransformerEmbedder
      model: all-MiniLM-L6-v2

    docs: !pw.io.fs.read
      path: ./docs
      format: binary
      with_metadata: true

Names starting with `$` are variables (not returned); `!dotted.path` tags
instantiate/call the referenced object with the mapping as kwargs. A
`!pw.` tag resolves inside pathway_tpu_torch; a tag naming the JAX
package (`!pathway_tpu.<name>`) raises ImportError.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, IO

import yaml


def _resolve_dotted(path: str) -> Any:
    if path.startswith("pw."):
        path = "pathway_tpu_torch." + path[3:]
    parts = path.split(".")
    if parts[0] == "pathway_tpu":
        # the port never imports the JAX package, and a manifest is no way
        # around that
        raise ImportError(
            f"cannot resolve {path!r}: pathway_tpu_torch does not import "
            "pathway_tpu (write !pw.<name> for this package)"
        )
    err = None
    for split in range(len(parts), 0, -1):
        module_name = ".".join(parts[:split])
        try:
            obj = importlib.import_module(module_name)
        except ImportError as exc:
            err = exc
            continue
        try:
            for attr in parts[split:]:
                obj = getattr(obj, attr)
        except AttributeError as exc:
            err = exc
            continue
        return obj
    raise ImportError(f"cannot resolve {path!r}: {err}")


class _Tagged:
    def __init__(self, path: str, value: Any):
        self.path = path
        self.value = value


class _Variable:
    def __init__(self, name: str):
        self.name = name


def _construct_unknown(loader, tag_suffix, node):
    if isinstance(node, yaml.MappingNode):
        value = loader.construct_mapping(node, deep=True)
    elif isinstance(node, yaml.SequenceNode):
        value = loader.construct_sequence(node, deep=True)
    else:
        value = loader.construct_scalar(node)
        if value == "":
            value = None
    return _Tagged(tag_suffix, value)


class _Loader(yaml.SafeLoader):
    pass


_Loader.add_multi_constructor("!", _construct_unknown)


def _instantiate(value: Any, variables: Dict[str, Any]) -> Any:
    if isinstance(value, _Tagged):
        target = _resolve_dotted(value.path)
        inner = _instantiate(value.value, variables)
        if inner is None:
            return target() if callable(target) else target
        if isinstance(inner, dict):
            return target(**inner)
        if isinstance(inner, list):
            return target(*inner)
        return target(inner)
    if isinstance(value, dict):
        return {
            k: _instantiate(v, variables) for k, v in value.items()
        }
    if isinstance(value, list):
        return [_instantiate(v, variables) for v in value]
    if isinstance(value, str) and value.startswith("$") and value[1:] in variables:
        return variables[value[1:]]
    return value


def load_yaml(stream: str | IO) -> Dict[str, Any]:
    """Load a YAML app manifest; returns the non-variable top-level objects
    (reference: yaml_loader.py load_yaml)."""
    if hasattr(stream, "read"):
        text = stream.read()
    else:
        text = stream
    raw = yaml.load(text, Loader=_Loader)  # noqa: S506 — SafeLoader subclass
    if raw is None:
        return {}
    variables: Dict[str, Any] = {}
    outputs: Dict[str, Any] = {}
    # two passes so $variables can be referenced by later entries
    for key, value in raw.items():
        is_var = key.startswith("$")
        name = key[1:] if is_var else key
        resolved = _instantiate(value, variables)
        variables[name] = resolved
        if not is_var:
            outputs[name] = resolved
    return outputs
