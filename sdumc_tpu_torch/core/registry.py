"""Generic name->factory registries: modules register themselves on import,
and an unknown name fails with the list of registered ones."""

from __future__ import annotations

from typing import Any, Callable, Dict


class Registry:
    def __init__(self, kind: str):
        self._kind = kind
        self._entries: Dict[str, Callable[..., Any]] = {}

    def register(self, name: str, factory: Callable[..., Any] | None = None):
        """Register a factory; usable as a decorator or a direct call."""
        if factory is not None:
            self._entries[name] = factory
            return factory

        def deco(fn):
            self._entries[name] = fn
            return fn

        return deco

    def get(self, name: str) -> Callable[..., Any]:
        if name not in self._entries:
            known = ", ".join(sorted(self._entries)) or "<none>"
            raise KeyError(
                f"Unknown {self._kind} {name!r}. Registered: {known}. "
                f"Register new entries via sdumc_tpu_torch.core.registry."
            )
        return self._entries[name]


MODELS = Registry("model")
DATASETS = Registry("dataset")
