"""Block registry: name → ``ConvBlock`` instance.

Port of ``repro.blocks.registry``: the single source of truth for which
convolution blocks exist.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

from repro_torch.blocks.base import ConvBlock

_REGISTRY: Dict[str, ConvBlock] = {}

BlockLike = Union[str, ConvBlock]


def register_block(block: ConvBlock, *, overwrite: bool = False) -> ConvBlock:
    """Register ``block`` under ``block.name``; returns it for chaining."""
    if block.name in _REGISTRY and not overwrite:
        raise ValueError(f"block {block.name!r} already registered "
                         f"(pass overwrite=True to replace)")
    _REGISTRY[block.name] = block
    return block


def unregister_block(name: str) -> None:
    """Remove a block (mainly for tests tearing down custom blocks)."""
    _REGISTRY.pop(name, None)


def get_block(block: BlockLike) -> ConvBlock:
    """Coerce a name or a ``ConvBlock`` to the registered instance."""
    if isinstance(block, ConvBlock):
        return block
    try:
        return _REGISTRY[block]
    except KeyError:
        raise KeyError(f"unknown conv block {block!r}; registered: "
                       f"{list_blocks()}") from None


def list_blocks() -> Tuple[str, ...]:
    """Registered block names, sorted for deterministic iteration."""
    return tuple(sorted(_REGISTRY))
