"""Multi-LoRA adapter management for the decode engine (port of
ray_tpu/llm/lora.py).

Execution model (S-LoRA-style batched gather):

- Every adapter's A/B factors are stacked into per-target tensors
  A[n_adapters, L, d, r], B[n_adapters, L, r, out] resident on the
  device.
- Each decode slot carries an adapter index (0 = the reserved null
  adapter, all zeros), so ONE decode step serves any mix of adapters in
  a batch: the per-layer delta is
      h @ A[aix, layer] @ B[aix, layer] * (alpha / r)
  — two small einsums gathered by batch row.
- Loading an adapter writes its factors into a preallocated slot of the
  stacked tensors in place, so hot-swap never reshapes the step's
  inputs (ray_tpu builds new arrays with ``.at[ix].set``).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

# Projection targets LoRA can attach to, in the transformer params
# layout (models/transformer.py): layers/attn/{wq,wk,wv,wo}.
TARGETS = ("wq", "wk", "wv", "wo")


class LoRAAdapter:
    """One adapter's factors, host-side.

    tensors: {"wq": (A [L, d, r], B [L, r, out]), ...} — any subset of
    TARGETS. alpha scales the delta by alpha / r (standard LoRA)."""

    def __init__(self, name: str, tensors: "dict[str, tuple]",
                 alpha: float = 16.0):
        self.name = name
        self.tensors = {}
        self.rank = None
        for tgt, (A, B) in tensors.items():
            if tgt not in TARGETS:
                raise ValueError(f"unknown LoRA target {tgt!r}; "
                                 f"supported: {TARGETS}")
            A = np.asarray(A, dtype=np.float32)
            B = np.asarray(B, dtype=np.float32)
            if A.ndim != 3 or B.ndim != 3 or A.shape[2] != B.shape[1]:
                raise ValueError(
                    f"{tgt}: want A [L,d,r] and B [L,r,out], got "
                    f"{A.shape} / {B.shape}")
            if self.rank is None:
                self.rank = A.shape[2]
            elif A.shape[2] != self.rank:
                raise ValueError("all targets must share one rank")
            self.tensors[tgt] = (A, B)
        if self.rank is None:
            raise ValueError("adapter has no tensors")
        self.alpha = float(alpha)

    @property
    def scale(self) -> float:
        return self.alpha / self.rank

    @classmethod
    def load(cls, name: str, path: str, alpha: float = 16.0):
        """Load from an .npz with keys '{target}.A' / '{target}.B'."""
        z = np.load(path)
        tensors: dict = {}
        for tgt in TARGETS:
            if f"{tgt}.A" in z and f"{tgt}.B" in z:
                tensors[tgt] = (z[f"{tgt}.A"], z[f"{tgt}.B"])
        return cls(name, tensors, alpha=alpha)


class LoRAManager:
    """Stacked device-resident adapter pool + name -> index registry.

    Index 0 is the reserved null adapter (zero factors): slots without
    an adapter compute a delta of exactly zero through the same step.
    """

    def __init__(self, n_layers: int, dims: "dict[str, tuple]",
                 max_adapters: int = 8, max_rank: int = 16, *,
                 device="cuda"):
        """dims: target -> (in_dim, out_dim). For the transformer layout
        (models/transformer.py): wq (d, H*Dh), wk/wv (d, KV*Dh),
        wo (H*Dh, d)."""
        self.max_adapters = max_adapters
        self.max_rank = max_rank
        self.n_layers = n_layers
        self.dims = dict(dims)
        self._lock = threading.Lock()
        self._names: dict[str, int] = {}
        self._free = list(range(1, max_adapters))
        # Indices unloaded while an in-flight sequence still referenced
        # them: factors stay intact (the sequence keeps computing the
        # delta it started with) and the slot is only recycled once the
        # engine confirms quiescence via reclaim().
        self._retired: set[int] = set()
        self._scales = torch.zeros((max_adapters,), dtype=torch.float32,
                                   device=device)
        # Stacked factors, zero-initialized (null adapter = index 0).
        self.stacked: dict[str, tuple] = {}
        for tgt, (din, dout) in self.dims.items():
            A = torch.zeros((max_adapters, n_layers, din, max_rank),
                            dtype=torch.float32, device=device)
            B = torch.zeros((max_adapters, n_layers, max_rank, dout),
                            dtype=torch.float32, device=device)
            self.stacked[tgt] = (A, B)

    # -- registry ----------------------------------------------------------

    def index_of(self, name: "str | None") -> int:
        if not name:
            return 0
        with self._lock:
            ix = self._names.get(name)
        if ix is None:
            raise KeyError(f"LoRA adapter {name!r} is not loaded")
        return ix

    def loaded(self) -> "list[str]":
        with self._lock:
            return sorted(self._names)

    def add(self, adapter: LoRAAdapter) -> int:
        """Load (or overwrite) an adapter into a pool slot."""
        if adapter.rank > self.max_rank:
            raise ValueError(
                f"adapter rank {adapter.rank} > pool max_rank "
                f"{self.max_rank}")
        with self._lock:
            ix = self._names.get(adapter.name)
            if ix is None:
                if not self._free:
                    raise RuntimeError(
                        f"LoRA pool full ({self.max_adapters - 1} "
                        "adapters); unload one first")
                ix = self._free.pop(0)
                self._names[adapter.name] = ix
            self._scales[ix] = adapter.scale
            for tgt, (A, B) in self.stacked.items():
                A[ix].zero_()
                B[ix].zero_()
                if tgt in adapter.tensors:
                    a_np, b_np = adapter.tensors[tgt]
                    r = a_np.shape[2]
                    A[ix, :, :, :r] = torch.from_numpy(a_np)
                    B[ix, :, :r, :] = torch.from_numpy(b_np)
        return ix

    def remove(self, name: str, active=()) -> bool:
        """Unload an adapter. ``active`` is the set of adapter indices
        still referenced by in-flight sequences (the engine's quiesce
        hook): a referenced slot is *retired* — name unregistered, but
        factors kept so those sequences finish with the deltas they
        started with — and only recycled by a later reclaim(). Without
        the deferral, remove→add can hand the slot to a new adapter
        while an in-flight batch row still gathers it, silently swapping
        its deltas mid-sequence."""
        with self._lock:
            ix = self._names.pop(name, None)
            if ix is None:
                return False
            if ix in active:
                self._retired.add(ix)
            else:
                self._release_slot_locked(ix)
            return True

    def reclaim(self, active=()) -> int:
        """Recycle retired slots no longer referenced by any in-flight
        sequence. Called by the engine between steps; returns how many
        slots were freed."""
        with self._lock:
            done = [ix for ix in self._retired if ix not in active]
            for ix in done:
                self._retired.discard(ix)
                self._release_slot_locked(ix)
            return len(done)

    def has_retired(self) -> bool:
        with self._lock:
            return bool(self._retired)

    def _release_slot_locked(self, ix: int) -> None:
        self._free.append(ix)
        self._scales[ix] = 0.0
        # Zero the slot so a stale index computes a zero delta.
        for A, B in self.stacked.values():
            A[ix].zero_()
            B[ix].zero_()

    # -- step inputs ---------------------------------------------------------

    def lora_tree(self) -> dict:
        """The tree handed to the prefill/decode steps: stacked factors
        plus per-adapter scales (the pool's own tensors, not copies)."""
        return {
            "scales": self._scales,
            **{tgt: {"A": A, "B": B}
               for tgt, (A, B) in self.stacked.items()},
        }


def lora_delta(h, lora_layer: dict, aix, scales):
    """Per-layer, per-target LoRA delta for a batch of rows, in float32.

    h: [B, T, d]; lora_layer: {"A": [n, d, r], "B": [n, r, out]} for ONE
    layer; aix: [B] adapter index per row; scales: [n]. Returns
    [B, T, out]."""
    A = lora_layer["A"][aix]          # [B, d, r]   (gather by row)
    B = lora_layer["B"][aix]          # [B, r, out]
    s = scales[aix]                   # [B]
    t = torch.einsum("btd,bdr->btr", h.float(), A)
    d = torch.einsum("btr,bro->bto", t, B)
    return d * s[:, None, None]
