"""Regenerate the reference-quirk golden mask fixture.

Run after any INTENTIONAL change to oracle_quirks semantics:
    python tests/make_quirk_golden.py
The fixture freezes the bug-compatible (reference-exact) masks so the
behaviour cannot silently drift (tests/test_reference_quirks.py).
"""
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402


def main():
    import jax

    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
    jax.config.update("jax_enable_x64", True)
    from tests.test_reference_quirks import GOLDEN, drive_quirk_oracle

    masks_q, masks_d = drive_quirk_oracle()
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(GOLDEN, **masks_q)
    agree = np.concatenate([(masks_q[n] == masks_d[n]).ravel() for n in masks_d])
    print(f"wrote {GOLDEN} ({len(masks_q)} contigs); "
          f"quirk-vs-default agreement {agree.mean():.6f}")


if __name__ == "__main__":
    main()
