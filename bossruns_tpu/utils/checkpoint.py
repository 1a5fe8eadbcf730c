"""Checkpoint / resume for experiment state.

The reference has NO model-state persistence (SURVEY.md §5: a crash of the
boss process loses all in-memory posteriors and the run restarts cold while
readfish keeps rejecting with the last mask). Here the full experiment state
— the device GenomeState pytree plus host-side control state (read-length
histogram, pseudotime, batch counter, processed files) — checkpoints
atomically each batch and restores on restart.
"""
from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np

logger = logging.getLogger("bossruns")


def save_checkpoint(out_dir: str | Path, state, host_state: dict, tag: str = "state",
                    extra_arrays: dict | None = None) -> Path:
    """Atomically persist a GenomeState-like NamedTuple + host dict.

    extra_arrays: host-side numpy arrays (e.g. the read-length histogram),
    stored in the same npz under 'host__<name>'.
    """
    from ..parallel.distributed import fetch, is_primary

    ckpt = Path(out_dir) / "checkpoint"
    final = ckpt / f"{tag}.npz"
    # fetch is a collective in multi-host runs (genome-sharded arrays
    # all-gather): EVERY process must execute it, then only the primary writes
    arrays = {k: fetch(v) for k, v in state._asdict().items()}
    if not is_primary():
        return final
    ckpt.mkdir(parents=True, exist_ok=True)
    tmp = ckpt / f"{tag}_tmp.npz"
    for k, v in (extra_arrays or {}).items():
        arrays[f"host__{k}"] = np.asarray(v)
    np.savez_compressed(tmp, **arrays)
    tmp.rename(final)
    meta_tmp = ckpt / f"{tag}_meta_tmp.json"
    meta = ckpt / f"{tag}_meta.json"
    meta_tmp.write_text(json.dumps(host_state, default=_coerce))
    meta_tmp.rename(meta)
    return final


def load_checkpoint(out_dir: str | Path, state_cls, tag: str = "state"):
    """Returns (state, host_state) or None if no checkpoint exists."""
    ckpt = Path(out_dir) / "checkpoint"
    final = ckpt / f"{tag}.npz"
    meta = ckpt / f"{tag}_meta.json"
    if not final.exists() or not meta.exists():
        return None
    with np.load(final) as z:
        fields = {k: z[k] for k in z}
    import jax.numpy as jnp

    extra = {k[len("host__"):]: v for k, v in fields.items() if k.startswith("host__")}
    state = state_cls(
        **{k: jnp.asarray(v) for k, v in fields.items() if not k.startswith("host__")}
    )
    host_state = json.loads(meta.read_text())
    logger.info(f"restored checkpoint from {final}")
    return state, host_state, extra


def _coerce(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, set):
        return sorted(o)
    raise TypeError(type(o))


class MetricsWriter:
    """Per-batch JSONL metrics into out_<name>/metrics/ — the reference
    creates the directory but never writes to it (SURVEY.md §5)."""

    def __init__(self, out_dir: str | Path, name: str = "batches"):
        self.path = Path(out_dir) / "metrics" / f"{name}.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def write(self, **fields) -> None:
        from ..parallel.distributed import is_primary

        if not is_primary():
            return
        with open(self.path, "a") as fh:
            fh.write(json.dumps(fields, default=_coerce) + "\n")
