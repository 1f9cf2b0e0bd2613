from repro_torch.utils.tree import (
    tree_add,
    tree_axpy,
    tree_dot,
    tree_global_norm,
    tree_scale,
    tree_size,
    tree_stack_flat,
    tree_sub,
    tree_unstack_flat,
    tree_zeros_like,
)

__all__ = [
    "tree_add",
    "tree_axpy",
    "tree_dot",
    "tree_global_norm",
    "tree_scale",
    "tree_size",
    "tree_stack_flat",
    "tree_sub",
    "tree_unstack_flat",
    "tree_zeros_like",
]
