"""Architecture registry (counterpart of ``repro.configs.registry``):
the same ids, every one of them runnable (the decoder families through
``models.lm``, the audio encoder-decoder through ``models.whisper``).
"""

from __future__ import annotations

import importlib

# assignment spellings (CLI: --arch <id>)
ARCHS = (
    "moonshot-v1-16b-a3b",
    "phi3.5-moe-42b-a6.6b",
    "recurrentgemma-9b",
    "qwen2.5-32b",
    "llama3.2-1b",
    "qwen1.5-0.5b",
    "qwen2-0.5b",
    "whisper-tiny",
    "qwen2-vl-7b",
    "falcon-mamba-7b",
)

# archs whose model family the port cannot run yet -> that family
UNPORTED: dict = {}


def _module(name: str):
    norm = name.replace(".", "_").replace("-", "_")
    known = {a.replace(".", "_").replace("-", "_"): a for a in ARCHS}
    if norm not in known:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    arch = known[norm]
    if arch in UNPORTED:
        raise NotImplementedError(
            f"arch {arch!r} is of the {UNPORTED[arch]!r} family, which "
            f"repro_torch does not run yet")
    return importlib.import_module("repro_torch.configs." + norm)


def get_config(name: str):
    return _module(name).config()


def get_smoke_config(name: str):
    return _module(name).smoke_config()
