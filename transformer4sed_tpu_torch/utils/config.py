"""YAML config system with ``include:`` inheritance (port of the JAX
package's ``utils/config.py``), on the port's own YAML reader and writer
(``utils/yamlio.py``): the card's machine has no PyYAML.

Same schema AND semantics as the reference loader
(``src/utils/__init__.py:24-37``): a config may contain ``include:
{base_path: <yaml>, keys: [...]}``; every listed top-level key is taken
from the base file, unconditionally overwriting a same-named section in
the including file (``main_content[key] = base_dict[key]``) — so list a
key in ``keys`` only when the base's version is wanted. ``base_path``
may be relative to the including file (this repo's configs) or to the
repo/config root as the reference's shipped configs are
(``./config/mat-sed/base/finetune1.yaml`` opened cwd-relative after the
mains chdir to the repo root); both resolve here, so the reference's
yamls load verbatim. The fully resolved config is dumped to the save
folder for reproducibility (``recipes/desed/setting.py:23-56``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from transformer4sed_tpu_torch.utils.yamlio import safe_dump, safe_load

# repo root: holds the vendored meta/ label tables (two levels up from
# utils/)
_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def resolve_meta_path(path: Optional[str]) -> Optional[str]:
    """Resolve a ``meta/...`` config path against the repo root when a
    cwd-relative lookup fails.

    The shipped configs point at the vendored label/split tables
    (``meta/audioset_strong/labeldict_audioset_strong.json``,
    ``meta/desed/...`` — mirroring the reference's ``meta/`` layout)
    with repo-relative paths; this makes them work from any cwd.
    """
    if path and not os.path.isabs(path) and not os.path.exists(path):
        cand = os.path.join(_REPO_ROOT, path)
        if os.path.exists(cand):
            return cand
    return path


def _resolve_meta_paths(node):
    """Recursively rewrite every ``meta/...`` string value in a config
    tree via :func:`resolve_meta_path` — applied once at load so ALL
    consumers (tsv readers included) see resolved paths."""
    if isinstance(node, dict):
        return {k: _resolve_meta_paths(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_meta_paths(v) for v in node]
    if isinstance(node, str) and node.startswith(("meta/", "meta" + os.sep)):
        return resolve_meta_path(node)
    return node


def _resolve_include_path(base_path: str, including_file: str) -> str:
    """Find the include base: absolute, file-relative, cwd-relative, or
    anchored at the including file's ``config/`` root (the reference's
    ``./config/...`` layout loaded from any cwd)."""
    if os.path.isabs(base_path):
        return base_path
    candidates = [os.path.join(os.path.dirname(including_file), base_path)]
    norm = base_path
    while norm.startswith("./"):
        norm = norm[2:]
    if norm.startswith("config/") or norm.startswith("config" + os.sep):
        # anchor at the path prefix before the including file's /config/.
        # This must outrank the bare cwd-relative candidate: otherwise a
        # config loaded from another checkout would silently include a
        # same-named base from the CURRENT repo's config tree.
        abs_file = os.path.abspath(including_file)
        marker = os.sep + "config" + os.sep
        if marker in abs_file:
            # the LAST /config/ before the file is the tree root — a repo
            # checked out under a path that itself contains /config/ must
            # not anchor at that outer occurrence
            root = abs_file.rsplit(marker, 1)[0]
            candidates.append(os.path.join(root, norm))
    candidates.append(base_path)  # cwd-relative (reference mains chdir to root)
    for cand in candidates:
        if os.path.exists(cand):
            return cand
    return candidates[0]  # let open() raise with the primary candidate


def load_yaml_with_include(path: str) -> Dict:
    with open(path) as f:
        config = safe_load(f.read())
    include = config.pop("include", None)
    if include:
        base_path = _resolve_include_path(include["base_path"], path)
        base = load_yaml_with_include(base_path)  # bases may include too
        for key in include["keys"]:
            # reference semantics: listed keys come from the base,
            # overwriting any same-named local section
            config[key] = base[key]
    return _resolve_meta_paths(config)


def save_config(config: Dict, save_folder: str, name: str = "config.yaml") -> str:
    os.makedirs(save_folder, exist_ok=True)
    out = os.path.join(save_folder, name)
    with open(out, "w") as f:
        f.write(safe_dump(config))
    return out


def get_save_directories(config: Dict, save_folder: str) -> Dict[str, str]:
    """Create the standard output layout and return its paths."""
    paths = {
        "save_folder": save_folder,
        "best_paths": os.path.join(save_folder, "best"),
        "scores": os.path.join(save_folder, "scores"),
        "log": os.path.join(save_folder, "log.txt"),
        "tensorboard": os.path.join(save_folder, "tensorboard"),
    }
    for key in ("save_folder", "best_paths", "scores", "tensorboard"):
        os.makedirs(paths[key], exist_ok=True)
    save_config(config, save_folder)
    return paths
