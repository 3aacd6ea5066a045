"""Tensor-parallel serving: one engine whose paged KV pools span mp
shards (counterpart of `paddle_tpu/serving/tp.py`).

A serving replica's ceiling is one device's memory: the weights plus
every resident's paged KV. `ServingEngine(mesh=...)` /
`PADDLE_TPU_MESH=dpXmpY` lays the attention's head axis over mp shards:

- every layer's K and V pools, and the int8 lane's scale pools, are
  split over their KV-HEAD axis into one contiguous pool per shard,
  [num_pages, page_size, H_kv / mp, D] on `devices[s]`: each shard
  holds a 1/mp slice of EVERY page, so the same per-device page budget
  admits about mp x the residents;
- the attention input projections (Llama's q/k/v_proj, GPT's fused
  qkv_proj, whose columns interleave q, k and v per head) are split over
  their output features in runs of whole heads: shard s computes its
  heads' queries, keys and values with the full contraction, the same
  columns the whole product gives;
- everything else — the MLP, the norms, the output projection, the
  embeddings and the LM head — and the scheduler, prefix cache,
  preemption, speculative decoding and HTTP layers stay single copies
  on the engine's (lead) device.

The port is ONE controller, as the JAX engine is one program over one
mesh: the engine process launches every shard's work itself. Per layer
the paged attention branch (`nlp.generation.attend_shards`) sends the
layer's input to each shard's device, projects the shard's heads, writes
and walks the shard's pools through the hand-written kernels with the
step's page table, positions, query counts and group operands sent once
a step to that device, and concatenates the shard outputs over the head
axis on the lead device — the one all-gather a layer — before the
replicated output projection. A walk folds its own kv heads only, so no
shard needs another's data and nothing is summed across shards: zero
all-reduces, which is why an mp > 1 engine reproduces the mp = 1 engine's
tokens. The output projection stays replicated on purpose: a
row-parallel one would sum partial products across shards, reordering
the floating-point reduction.

`dp` is validated and counted as in the JAX package, but its replicas
hold no separate work here: the single controller runs the replicated
part once, on the lead device, and the shards are the first mp devices.

Devices: on a machine with CUDA the visible devices are the distinct
CUDA devices; on the CPU, PADDLE_TPU_FORCE_CPU_DEVICES virtual CPU
devices (the JAX package's variable for its virtual mesh), else one.
`ServingTP(dp, mp, devices=[...])` takes any list, with repeats: mp
shards on one card run every per-shard launch and every gather for real.
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import torch

__all__ = ["ServingTP", "resolve_serving_mesh", "parse_mesh_spec",
           "collective_counts", "visible_devices", "COLLECTIVE_KINDS"]

# env spec: "dp2mp4" (also "dp2xmp4"); "off"/"" = single-device serving
_MESH_RE = re.compile(r"^dp(\d+)x?mp(\d+)$")

# parameter-name fragments of the attention input projections, the
# weights split over mp (whole heads of output features); the rest stays
# replicated (see the module doc)
_QKV_MARKERS = ("q_proj.", "k_proj.", "v_proj.", "qkv_proj.")

# the JAX census's keys, then the port's own: `broadcast` counts the
# per-layer send of the attention input to the shards
COLLECTIVE_KINDS = ("all_reduce", "all_gather", "reduce_scatter",
                    "all_to_all", "collective_permute")


def parse_mesh_spec(spec: str):
    """'dpXmpY' -> (dp, mp); raises ValueError on anything else."""
    m = _MESH_RE.match(spec.strip().lower())
    if m is None:
        raise ValueError(
            f"mesh spec must look like 'dp2mp4' "
            f"(PADDLE_TPU_MESH / ServingEngine(mesh=...)), got "
            f"{spec!r}")
    dp, mp = int(m.group(1)), int(m.group(2))
    if dp < 1 or mp < 1:
        raise ValueError(
            f"mesh axes must be >= 1, got dp={dp} mp={mp}")
    return dp, mp


def visible_devices() -> List[torch.device]:
    """The devices a mesh may span: the distinct CUDA devices where CUDA
    is available, else PADDLE_TPU_FORCE_CPU_DEVICES virtual CPU devices
    (one without it)."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    n = int(os.environ.get("PADDLE_TPU_FORCE_CPU_DEVICES") or 1)
    return [torch.device("cpu")] * max(1, n)


class ServingTP:
    """The engine's tensor-parallel state: a (dp, mp) grid over the first
    dp * mp of `devices` (default: the visible ones) and the placement
    of every sharded engine tensor. Shard s lives on `devices[s]`."""

    def __init__(self, dp: int, mp: int, devices=None):
        self.dp, self.mp = int(dp), int(mp)
        n = self.dp * self.mp
        devs = list(visible_devices() if devices is None else
                    [torch.device(d) for d in devices])
        if n > len(devs):
            raise ValueError(
                f"serving mesh dp{self.dp}xmp{self.mp} needs {n} "
                f"devices but only {len(devs)} are visible; shrink "
                f"the mesh or provision more chips "
                f"(CPU simulation: PADDLE_TPU_FORCE_CPU_DEVICES)")
        # the shards' devices: the (dp, mp) grid's first row (see the
        # module doc)
        self.devices = devs[:self.mp]

    @property
    def shape(self) -> str:
        return f"dp{self.dp}xmp{self.mp}"

    @property
    def size(self) -> int:
        return self.dp * self.mp

    def __repr__(self):
        return f"ServingTP({self.shape})"

    # -- construction-time geometry validation -----------------------------
    def validate_geometry(self, *, n_kv: int, n_heads: int,
                          hidden: int):
        """Raise a clear ValueError when the model's head geometry
        cannot shard over this mesh's mp degree, before anything is
        placed; the legal mp values are named in the error."""
        if self.mp <= 1:
            return
        if n_kv % self.mp and n_heads % self.mp:
            bad = f"H_kv={n_kv} and H={n_heads} are"
        elif n_kv % self.mp:
            bad = f"H_kv={n_kv} is"
        elif n_heads % self.mp or hidden % self.mp:
            bad = f"H={n_heads} (hidden={hidden}) is"
        else:
            return
        n_dev = len(visible_devices())
        legal = [m for m in range(1, n_kv + 1)
                 if n_kv % m == 0 and n_heads % m == 0
                 and hidden % m == 0 and m <= n_dev]
        raise ValueError(
            f"serving mesh {self.shape}: {bad} not divisible by "
            f"mp={self.mp} — the paged KV pools shard over the "
            f"kv-head axis and the QKV projections over whole heads, "
            f"so every head count must split evenly across the mp "
            f"shards (model: H_kv={n_kv}, H={n_heads}, "
            f"hidden={hidden}). Legal mp values for this model on "
            f"{n_dev} visible devices: {legal}")

    # -- placement ---------------------------------------------------------
    def _split(self, t: torch.Tensor, dim: int) -> List[torch.Tensor]:
        """t cut into mp equal runs along `dim`, run s as a contiguous
        tensor of its own on devices[s] (the walks and scatters take
        contiguous pools only)."""
        return [c.to(d).contiguous()
                for c, d in zip(t.chunk(self.mp, dim), self.devices)]

    def place_state(self, model) -> List[Dict[str, torch.Tensor]]:
        """The engine's shard copies of the attention input projections:
        per shard, {parameter name: its run of output features} (a Linear
        weight [out, in] split over dim 0, its bias over dim 0). The
        model's own parameters are never touched or rebound: the rest
        runs from them, replicated, on the lead device."""
        placed: List[Dict[str, torch.Tensor]] = [{} for _ in self.devices]
        for name, p in model.named_parameters():
            if any(mk in name for mk in _QKV_MARKERS) \
                    and p.shape[0] % self.mp == 0:
                for s, piece in enumerate(self._split(p.detach(), 0)):
                    placed[s][name] = piece
        return placed

    def place_pool(self, t: torch.Tensor) -> List[torch.Tensor]:
        """One layer's K or V pool [num_pages, page_size, H_kv, D] ->
        the shards' pools [num_pages, page_size, H_kv / mp, D]."""
        return self._split(t, 2)

    def place_scale(self, t: torch.Tensor) -> List[torch.Tensor]:
        """One int8 scale pool [num_pages, page_size, H_kv] -> the
        shards' [num_pages, page_size, H_kv / mp]."""
        return self._split(t, 2)

    def place_adapter_col(self, t: torch.Tensor) -> List[torch.Tensor]:
        """One adapter-pool B tensor [P, R, out] of a q/k/v projection ->
        the shards' [P, R, out / mp]: each shard adds its own columns'
        delta (the geometry check makes out divisible)."""
        return self._split(t, 2)

    def replicate(self, t: torch.Tensor) -> List[torch.Tensor]:
        """A step operand (page table, positions, query counts, group
        operands, ...) on every shard's device."""
        return [t.to(d) for d in self.devices]

    # -- the modeled per-step collective count ------------------------------
    def step_collectives(self, n_layers: int) -> int:
        """The sharded step's modeled collectives, the number the flight
        recorder logs per launch: one output all-gather a layer, zero
        all-reduces. `collective_counts()` holds the engine's counted
        transfers to it."""
        return int(n_layers) if self.mp > 1 else 0


def resolve_serving_mesh(override=None,
                         env: str = "PADDLE_TPU_MESH"
                         ) -> Optional[ServingTP]:
    """The engine's mesh gate. An explicit override wins: None defers
    to the env var, False forces single-device, a ServingTP passes
    through, a 'dpXmpY' string or a (dp, mp) pair builds one.
    PADDLE_TPU_MESH='' or 'off' (the default) is single-device serving.
    Read at engine construction. (The JAX resolver also takes a jax
    Mesh, which the port cannot receive: any other type raises.)"""
    if override is None:
        spec = os.environ.get(env, "off").strip()
        if spec in ("", "off"):
            return None
        return ServingTP(*parse_mesh_spec(spec))
    if override is False:
        return None
    if isinstance(override, ServingTP):
        return override
    if isinstance(override, str):
        return ServingTP(*parse_mesh_spec(override))
    if isinstance(override, (tuple, list)) and len(override) == 2:
        return ServingTP(int(override[0]), int(override[1]))
    raise ValueError(
        f"mesh must be None/False, a 'dpXmpY' spec, a (dp, mp) "
        f"tuple, a ServingTP, or a jax Mesh/ProcessMesh with dp/mp "
        f"axes; got {type(override).__name__}")


# HLO op spellings of the collectives (async pairs count once via their
# -start form), for a compiled program's text
_COLL_RE = {
    "all_reduce": re.compile(r"\ball-reduce(?:-start)?\("),
    "all_gather": re.compile(r"\ball-gather(?:-start)?\("),
    "reduce_scatter": re.compile(r"\breduce-scatter\("),
    "all_to_all": re.compile(r"\ball-to-all\("),
    "collective_permute":
        re.compile(r"\bcollective-permute(?:-start)?\("),
}


def new_transfer_counts() -> Dict[str, int]:
    """A zeroed record of one step's cross-shard transfers, by kind."""
    return dict.fromkeys(COLLECTIVE_KINDS + ("broadcast",), 0)


def collective_counts(source) -> dict:
    """The collectives of a step. Given a compiled HLO module's text (the
    JAX package's source), the count of each collective spelled in it.
    Given the engine's transfer record (`new_transfer_counts`, filled by
    the shard route), the transfers the port's step made, under the same
    keys plus `broadcast`: the per-layer send of the attention input to
    the shards, a transfer GSPMD does not need (its shards compute the
    replicated layers themselves) but the single controller does. The
    serving contract: `all_reduce == 0` and `all_gather == n_layers`, one
    output gather a layer a step."""
    if isinstance(source, str):
        return {name: len(rx.findall(source))
                for name, rx in _COLL_RE.items()}
    return {name: int(source.get(name, 0))
            for name in COLLECTIVE_KINDS + ("broadcast",)}
