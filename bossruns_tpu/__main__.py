"""CLI entry point: dispatches the 4 experiment modes from one TOML.

Equivalent of the reference's boss/BOSS.py: live/simulation x RUNS/AEONS is
selected by presence of simulation.fq (sim) and general.ref (RUNS vs AEONS).

    python -m bossruns_tpu --toml config.toml
"""
from __future__ import annotations

import logging
import sys
import time

from .config import Config

logger = logging.getLogger("bossruns")


def main(argv=None) -> int:
    # multi-host: join the distributed runtime BEFORE the first jax use
    # (BOSS_COORDINATOR/BOSS_NUM_PROCESSES/BOSS_PROCESS_ID env; no-op when
    # unset). After this jax.devices() is the global device list and the
    # [tpu] mesh shards may span hosts; file outputs happen on process 0.
    from .parallel.distributed import init_from_env
    from .utils.compile_cache import configure_compile_cache

    init_from_env()
    configure_compile_cache()

    # the decision path (benefit sums, threshold scan) runs in f64 — see
    # RunsConfig.benefit_dtype; without x64 it silently falls back to f32
    import jax

    jax.config.update("jax_enable_x64", True)
    conf = Config(parse=True, argv=argv)
    args = conf.args
    sim = bool(args.simulation.fq)
    runs = bool(args.general.ref)

    if not sim and runs:
        from .models.experiment import BossRuns

        exp = BossRuns(args)
        exp.launch_live_components()
        while True:
            wait = exp.process_batch()
            if wait > 0:
                time.sleep(wait)

    elif sim and runs:
        from .models.runs_sim import BossRunsSim

        exp = BossRunsSim(
            ref=args.general.ref,
            fq=args.simulation.fq,
            paf_full=args.simulation.paf_full,
            paf_trunc=args.simulation.paf_trunc,
            name=args.general.name,
            batchsize=args.simulation.batchsize,
            maxb=args.simulation.maxb,
            dumptime=args.simulation.dumptime,
            barcodes=args.general.barcodes,
            reject_refs=args.optional.reject_refs,
            ploidy=args.optional.ploidy,
            accept_unmapped=args.simulation.accept_unmapped,
            mesh_shards=(args.tpu.mesh_barcode, args.tpu.mesh_genome),
            resume=args.optional.resume,
        )
        exp.run()
        logger.info("simulation finished")

    elif sim and not runs:
        from .aeons.simulation import BossAeonsSim

        exp = BossAeonsSim(args)
        exp.run()

    else:
        from .aeons.core import BossAeons

        exp = BossAeons(args)
        exp.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
