"""Module-tree DSL and the llama tree: what a layer quantizes, in which order.

The llama subset of the JAX package's ``models/module_tree.py`` with the
llama entry of ``models/definitions.py`` and its shared-input table. A tree
is ``["model", "layers", "#", {submodule: (leaves)}]``: segments before
``#`` are the path to the decoder-layer list; a leaf ``"name:N"`` is
quantized in subset ``N`` (true-sequential stage), ``"name:!"`` is
capture-only, and a leaf named like its parent key is the parent module.
Expert (MoE) subtrees come with the MoE slice (ROADMAP queue 1, "MoE
quantization, then MoE breadth").

For llama this gives two subsets per layer, ``[q, k, v, gate, up]`` then
``[o, down]``, and four input groups (qkv, gate_up, o, down): modules of one
group read the same input, so they share one Hessian and one solve.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class ModuleEntry:
    """One quantizable (or capture-only) module, relative to its layer."""

    path: str  # e.g. "self_attn.q_proj"
    subset: int  # stage index within the layer (-1 for capture-only)
    capture_only: bool = False


@dataclass
class LayerPlan:
    layers_path: str  # e.g. "model.layers"
    entries: list[ModuleEntry] = field(default_factory=list)

    def build_subsets(self) -> list[list[str]]:
        """Per-layer subsets of module paths in execution order."""
        quant = [e for e in self.entries if not e.capture_only]
        subsets: list[list[str]] = [[] for _ in range(1 + max((e.subset for e in quant),
                                                              default=-1))]
        for e in quant:
            subsets[e.subset].append(e.path)
        return [s for s in subsets if s]


def parse_module_tree(tree) -> LayerPlan:
    """Parse the list-form DSL into a LayerPlan."""
    prefix: list[str] = []
    i = 0
    while i < len(tree) and isinstance(tree[i], str):
        if tree[i] == "#":
            i += 1
            break
        prefix.append(tree[i])
        i += 1
    if i >= len(tree) or not isinstance(tree[i], dict):
        raise ValueError(f"module_tree must end in a '#' + dict, got: {tree!r}")
    plan = LayerPlan(layers_path=".".join(prefix))
    _walk(tree[i], [], plan)
    plan.entries.sort(key=lambda e: e.subset)  # stable: declaration order within a subset
    return plan


def _walk(node, prefix: list[str], plan: LayerPlan):
    if isinstance(node, dict):
        for key, val in node.items():
            _walk(val, prefix + [key.split(":")[0]], plan)
    elif isinstance(node, (tuple, list)):
        for leaf in node:
            name, *tags = leaf.split(":")
            parts = prefix if prefix and name == prefix[-1] else prefix + [name]
            capture = "!" in tags
            subset = next((int(t) for t in tags if t.isdigit()), 0)
            plan.entries.append(ModuleEntry(path=".".join(parts),
                                            subset=-1 if capture else subset,
                                            capture_only=capture))
    else:
        raise ValueError(f"bad module_tree node: {node!r}")


LLAMA_TREE = (
    "model",
    "layers",
    "#",
    {
        "input_layernorm": ("input_layernorm:!",),
        "self_attn": ("q_proj:0", "k_proj:0", "v_proj:0", "o_proj:1"),
        "post_attention_layernorm": ("post_attention_layernorm:!",),
        "mlp": ("gate_proj:0", "up_proj:0", "down_proj:1"),
    },
)

# Llama's modules whose inputs are identical in the functional forward: they
# share one Hessian and one batched solve.
SHARED_INPUT_LEAVES = {
    "q_proj": "qkv",
    "k_proj": "qkv",
    "v_proj": "qkv",
    "gate_proj": "gate_up",
    "up_proj": "gate_up",
}


def input_group_key(path: str) -> str:
    """Canonical input-group key for a module path within a layer."""
    parent, _, leaf = path.rpartition(".")
    shared = SHARED_INPUT_LEAVES.get(leaf)
    return f"{parent}::{shared}" if shared else path
