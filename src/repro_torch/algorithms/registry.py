"""The sampler-backend registry (``repro/algorithms/registry.py``): one
name resolves to one backend instance in both packages."""
from __future__ import annotations

from typing import Dict, List, Tuple, Type

from repro_torch.algorithms.base import SamplerBackend

# name -> backend instance; aliases map to the same instance
_REGISTRY: Dict[str, SamplerBackend] = {}
_PRIMARY: List[str] = []  # registration order, aliases excluded


def register(name: str, *aliases: str):
    """Class decorator: instantiate the backend and register it under
    ``name`` plus any aliases."""

    def deco(cls: Type[SamplerBackend]) -> Type[SamplerBackend]:
        for n in (name,) + aliases:
            if n in _REGISTRY:
                raise ValueError(f"sampler backend {n!r} already registered")
        instance = cls()
        instance.name = name
        for n in (name,) + aliases:
            _REGISTRY[n] = instance
        _PRIMARY.append(name)
        return cls

    return deco


def get(name: str) -> SamplerBackend:
    """Resolve a backend name; unknown names raise with the full list."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown sampler backend {name!r}; registered backends: "
            f"{', '.join(sorted(_REGISTRY))}"
        ) from None


def registered() -> Tuple[str, ...]:
    """Primary backend names in registration order."""
    return tuple(_PRIMARY)


def describe() -> List[Tuple[str, SamplerBackend, Tuple[str, ...]]]:
    """(primary name, backend, aliases) for every entry — CLI listings."""
    out = []
    for name in _PRIMARY:
        b = _REGISTRY[name]
        aliases = tuple(n for n, inst in _REGISTRY.items()
                        if inst is b and n != name)
        out.append((name, b, aliases))
    return out
