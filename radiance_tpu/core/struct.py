"""Frozen dataclasses registered as JAX pytrees.

The small subset of `flax.struct` this package uses: `dataclass` makes a
frozen dataclass whose fields are pytree children unless declared with
`field(pytree_node=False)`, in which case they ride in the treedef as
static metadata.  Instances gain `.replace(**changes)`.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """dataclasses.field with a pytree_node flag (False = static)."""
    return dataclasses.field(metadata={"pytree_node": pytree_node},
                             **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    data = [f.name for f in fields if f.metadata.get("pytree_node", True)]
    meta = [f.name for f in fields
            if not f.metadata.get("pytree_node", True)]
    jax.tree_util.register_dataclass(cls, data_fields=data,
                                     meta_fields=meta)
    cls.replace = _replace
    return cls
