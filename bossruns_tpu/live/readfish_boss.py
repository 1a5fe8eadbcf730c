"""BOSS-modified readfish entry point: the real-time per-chunk decision loop.

Full equivalent of /root/reference/boss/readfish_boss.py (a fork of readfish's
targets.py): hold the live connection to the sequencer, basecall signal
chunks, map them, resolve each read against the BOSS strategy masks (which
hot-reload from masks/boss.npz; AEONS also reloads the contig index), apply
the override ladder (control region, min/max chunks, duplex, first read,
dry-run — reference :296-445), and deliver unblock / stop_receiving batches.

The sequencer stack (`readfish`, `minknow_api`, a basecaller) only exists on
a sequencer host, so every hardware import is deferred; the loop itself runs
against anything that implements the small client/caller/mapper protocols
below (see tests/test_readfish_loop.py for in-repo fakes, mirroring how the
reference unit-tests this file via the `return_conf` hook,
tests/playback/test_dynamic_readfish.py:20-38).

Run:  python -m bossruns_tpu.live.readfish_boss <toml_readfish> <device> <name>
"""
from __future__ import annotations

import argparse
import logging
import sys
import time
from pathlib import Path

from .conf import Action, Chemistry, Condition, RFConf
from .decision import ContigWatcher, Decision, StrategyStore, make_decision

logger = logging.getLogger("bossruns")

#: duplex overrides are only granted when the channel's previous decision was
#: a genuine accept (reference DISALLOWED_DUPLEX_DECISIONS)
DISALLOWED_DUPLEX_DECISIONS = (
    Decision.duplex_override,
    Decision.first_read_override,
    Decision.no_map,
    Decision.no_seq,
)


# ----------------------------------------------------------- loop trackers --

class ChunkTracker:
    """Seen-count per (channel, read) keyed BY CHANNEL, so memory is bounded
    by the channel count — a new read on a channel evicts the previous entry
    (reads that vanish between chunks can never leak)."""

    def __init__(self, channels: int):
        self.slots: dict[int, tuple[object, int]] = {}
        self.channels = channels

    def seen(self, channel: int, read_id) -> int:
        prev_id, count = self.slots.get(channel, (None, 0))
        count = count + 1 if prev_id == read_id else 1
        self.slots[channel] = (read_id, count)
        return count


class PreviouslySentActionTracker:
    """Last final Action sent per channel (None = channel never decided)."""

    def __init__(self):
        self.actions: dict[int, Action] = {}

    def add_action(self, channel: int, action: Action) -> None:
        self.actions[channel] = action

    def get_action(self, channel: int) -> Action | None:
        return self.actions.get(channel)


class DuplexTracker:
    """Previous decision + alignments per channel for duplex overrides."""

    def __init__(self):
        self.decisions: dict[int, Decision] = {}
        self.alignments: dict[int, list[tuple[str, int]]] = {}

    def set_decision(self, channel: int, decision: Decision) -> None:
        self.decisions[channel] = decision

    def get_previous_decision(self, channel: int) -> Decision | None:
        return self.decisions.get(channel)

    def set_alignments(self, channel: int, aligns: list[tuple[str, int]]) -> None:
        self.alignments[channel] = aligns

    def possible_duplex(self, channel: int, read_id, ctg: str, strand: int) -> bool:
        """Second strand of a duplex: previous read on this channel aligned
        to the same contig on the opposite strand."""
        return any(
            prev_ctg == ctg and prev_strand != strand
            for prev_ctg, prev_strand in self.alignments.get(channel, [])
        )


class ReadfishStatistics:
    """Per-batch performance + per-read TSV debug log (readfish parity:
    reference readfish_boss.py:220-222, 535-573)."""

    TSV_HEADER = (
        "client_iteration\tread_in_loop\tread_id\tchannel\tseq_len\tcounter\t"
        "mode\tdecision\tcondition\tbarcode\tprevious_action\taction_overridden\t"
        "timestamp\tregion_name\toverridden_action_name\n"
    )

    def __init__(self, log_file: str | None = None):
        self.total_reads = 0
        self.batches = 0
        self.batch_times: list[float] = []
        self.decision_counts: dict[str, int] = {}
        self.action_counts: dict[str, int] = {}
        self._fh = None
        if log_file:
            self._fh = open(log_file, "a", buffering=1)
            if self._fh.tell() == 0:
                self._fh.write(self.TSV_HEADER)

    def log_read(self, **row) -> None:
        self.total_reads += 1
        mode = row.get("mode", "")
        self.decision_counts[mode] = self.decision_counts.get(mode, 0) + 1
        act = row.get("decision", "")
        self.action_counts[act] = self.action_counts.get(act, 0) + 1
        if self._fh is not None:
            cols = (
                "client_iteration", "read_in_loop", "read_id", "channel",
                "seq_len", "counter", "mode", "decision", "condition",
                "barcode", "previous_action", "action_overridden", "timestamp",
                "region_name", "overridden_action_name",
            )
            self._fh.write("\t".join(str(row.get(c, "")) for c in cols) + "\n")

    def add_batch_performance(self, number_of_reads: int, batch_time: float) -> None:
        self.batches += 1
        self.batch_times.append(batch_time)

    def get_batch_performance(self) -> str:
        if not self.batch_times:
            return "no batches yet"
        last = self.batch_times[-1]
        mean = sum(self.batch_times) / len(self.batch_times)
        return (
            f"batch {self.batches}: {last*1000:.0f} ms "
            f"(mean {mean*1000:.0f} ms), {self.total_reads} reads total, "
            f"actions {self.action_counts}"
        )

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()


# ------------------------------------------------------------- boss bits ----

class BossBits:
    """Strategy + contig hot-reload state for the readfish loop
    (reference boss/dynamic_readfish.py:20-166)."""

    def __init__(self, conf, logger, mapper, barcode_index: dict | None = None,
                 out_base: str | Path = "."):
        self.mapper = mapper
        self.masks_path = None
        self.contigs_path = None
        # the non-control region's name locates the mask directory
        for region in conf.regions:
            if getattr(region, "control", False):
                continue
            out = Path(out_base) / f"out_{region.name}"
            self.masks_path = out / "masks" / "boss.npz"
            self.contigs_path = out / "contigs" / "aeons.fa"
        self.store = (
            StrategyStore(self.masks_path, barcode_index=barcode_index)
            if self.masks_path else None
        )
        self.watcher = None
        if self.contigs_path is not None and mapper is not None:
            self.watcher = ContigWatcher(self.contigs_path, self._rebuild_mapper)

    @staticmethod
    def gen_dummy_idx(path: str | Path = "readfish_index.fa") -> Path:
        """Write a dummy index target so an aligner plugin can initialise
        before real contigs exist (dynamic_readfish.py:260-271; AEONS starts
        with no reference)."""
        p = Path(path)
        p.write_text(">init\n" + "A" * 25 + "\n")
        return p

    def _rebuild_mapper(self, fasta: str) -> None:
        # AEONS only: swap the aligner index for the new contigs
        # (dynamic_readfish.py:113-139)
        try:
            self.mapper.load_index(fasta)
        except Exception as e:  # noqa: BLE001 - keep old index on failure
            logger.info(f"contig index rebuild failed: {e}")

    def reload(self) -> None:
        if self.store is not None:
            self.store.reload()
        if self.watcher is not None:
            self.watcher.maybe_rebuild()

    def decide(self, result) -> Decision:
        """Map a readfish Result to a decision (dynamic_readfish.py:213-257)."""
        alignments = getattr(result.alignment_data, "alignments", result.alignment_data)
        barcode = getattr(result, "barcode", None)
        return make_decision(self.store, alignments or [], len(result.seq), barcode)


# --------------------------------------------------------------- analysis ---

class Analysis:
    """The per-chunk decision worker (reference readfish_boss.py:128-586).

    client/caller/mapper follow the readfish plugin protocols:
      client:  .is_sequencing, .channel_count, .get_read_chunks(n, last),
               .unblock_read_batch(list, duration), .stop_receiving_batch(list),
               optionally .wait_for_sequencing_to_start, .mk_run_dir,
               .signal_dtype, .calibration_values
      caller:  .basecall(chunks, signal_dtype, calibration) -> iterable
      mapper:  .map_reads(calls) -> iterable of Result-likes with .channel,
               .read_id, .read_number, .seq, .alignment_data, .barcode;
               .initialised; optionally .load_index(fasta)
    """

    def __init__(
        self,
        client,
        conf,
        logger: logging.Logger,
        caller=None,
        mapper=None,
        debug_log: str | None = None,
        throttle: float = 0.4,
        unblock_duration: float = 0.1,
        dry_run: bool = False,
        toml: str | None = None,
        chemistry: Chemistry = Chemistry.SIMPLEX,
        barcode_index: dict | None = None,
        out_base: str | Path = ".",
    ):
        self.client = client
        self.conf = conf
        self.logger = logger
        self.throttle = throttle
        self.unblock_duration = unblock_duration
        self.dry_run = dry_run
        self.chemistry = chemistry
        self.live_toml = Path(f"{toml}_live").resolve() if toml else None
        # plugins: explicit objects, or loaded from the conf's settings blocks
        self.caller = caller if caller is not None else self._load_caller()
        self.mapper = mapper if mapper is not None else self._load_mapper()
        # startup descriptions (reference readfish_boss.py:229 caller, :460
        # mapper)
        if hasattr(self.caller, "describe"):
            logger.info(self.caller.describe())
        self.loop_statistics = ReadfishStatistics(debug_log)
        self.chunk_tracker = ChunkTracker(getattr(client, "channel_count", 512))
        self.previous_action_tracker = PreviouslySentActionTracker()
        self.duplex_tracker = DuplexTracker()
        # if readfish starts mid-sequencing, the first chunk seen per channel
        # is from a read of unknown elapsed length -> always sequence it
        self.readfish_started_during_sequencing = True
        self.log_once_in_loop = True
        self.boss = BossBits(
            conf=conf, logger=logger, mapper=self.mapper,
            barcode_index=barcode_index, out_base=out_base,
        )

    # ------------------------------------------------------------ plugins --

    def _load_caller(self):
        """Load the basecaller from conf.caller_settings (readfish plugin).
        Only reachable on a sequencer host."""
        load = getattr(self.conf, "caller_settings", None)
        if hasattr(load, "load_object"):
            return load.load_object("Caller")
        raise RuntimeError(
            "no caller provided and conf has no loadable caller_settings; "
            "pass caller= explicitly (sequencer hosts load the readfish plugin)"
        )

    def _load_mapper(self):
        load = getattr(self.conf, "mapper_settings", None)
        if hasattr(load, "load_object"):
            return load.load_object("Aligner")
        raise RuntimeError(
            "no mapper provided and conf has no loadable mapper_settings; "
            "pass mapper= explicitly"
        )

    # ------------------------------------------------------------- phases --

    @property
    def wait_for_sequencing(self) -> bool:
        """True while MinKNOW is not in PHASE_SEQUENCING (reference :251-268)."""
        if getattr(self.client, "wait_for_sequencing_to_start", False):
            if self.log_once_in_loop:
                self.logger.info("waiting for PHASE_SEQUENCING to begin")
                self.log_once_in_loop = False
            self.readfish_started_during_sequencing = False
            return True
        return False

    def reload_toml(self, last_toml_mtime: float) -> float:
        """Hot-reload <toml>_live when its mtime advances (reference
        :270-294); errors keep the old conf."""
        if self.live_toml is None or not self.live_toml.is_file():
            return last_toml_mtime
        mtime = self.live_toml.stat().st_mtime
        if mtime > last_toml_mtime:
            try:
                self.conf = type(self.conf).from_file(
                    self.live_toml, getattr(self.client, "channel_count", 512)
                )
                self.logger.info("reloaded live toml")
            except Exception as e:  # noqa: BLE001 - keep serving with old conf
                self.logger.error(f"live toml reload failed: {e}")
            last_toml_mtime = mtime
        return last_toml_mtime

    # ------------------------------------------------------------ override --

    def check_override_action(
        self,
        control: bool,
        action: Action,
        result,
        seen_count: int,
        condition: Condition,
        stop_receiving_action_list: list,
        unblock_batch_action_list: list,
    ) -> tuple[Action, Action | None, bool, str | None]:
        """The override ladder (reference :296-445), applied in order:

        1. control region             -> stop_receiving
        2. above max_chunks + proceed -> condition.above_max_chunks
        3. below min_chunks + action  -> condition.below_min_chunks
        4. duplex chemistry           -> stop_receiving for likely 2nd strands
        5. first read on a channel when started mid-sequencing -> stop_receiving
        6. dry run                    -> unblocks become stop_receiving

        Appends to the action lists in place; returns
        (action, previous_action, overridden?, overridden_action_name).
        """
        if control:
            action = Action.stop_receiving
        else:
            below_min_chunks = seen_count < condition.min_chunks
            above_max_chunks = seen_count > condition.max_chunks
            if above_max_chunks and action is Action.proceed:
                action = condition.above_max_chunks
                result.decision = Decision.above_max_chunks
            if below_min_chunks and action is not Action.proceed:
                action = condition.below_min_chunks
                result.decision = Decision.below_min_chunks

        previous_action = self.previous_action_tracker.get_action(result.channel)
        action_overridden = False

        if (
            self.chemistry is Chemistry.DUPLEX
            and action is Action.unblock
            and previous_action is Action.stop_receiving
        ):
            alignments = getattr(
                result.alignment_data, "alignments", result.alignment_data
            ) or []
            possible_duplex = any(
                self.duplex_tracker.possible_duplex(
                    result.channel, result.read_id, al.ctg, al.strand
                )
                for al in alignments
            )
            previous_decision_allowed = (
                self.duplex_tracker.get_previous_decision(result.channel)
                not in DISALLOWED_DUPLEX_DECISIONS
            )
            if possible_duplex and previous_decision_allowed:
                action_overridden = True
                result.decision = Decision.duplex_override
                action = Action.stop_receiving
        elif (
            self.chemistry is Chemistry.DUPLEX_SIMPLE
            and previous_action is Action.stop_receiving
            and action is Action.unblock
        ):
            if (
                self.duplex_tracker.get_previous_decision(result.channel)
                not in DISALLOWED_DUPLEX_DECISIONS
            ):
                action = Action.stop_receiving
                action_overridden = True
                result.decision = Decision.duplex_override

        if previous_action is None and self.readfish_started_during_sequencing:
            action_overridden = True
            result.decision = Decision.first_read_override
            action = Action.stop_receiving

        # action payloads carry (channel, read_id) — byte-compatible with the
        # reference's Read Until batches (readfish_boss.py:416-424)
        if action is Action.stop_receiving:
            stop_receiving_action_list.append((result.channel, result.read_id))
        elif action is Action.unblock:
            if self.dry_run:
                action_overridden = True
                stop_receiving_action_list.append((result.channel, result.read_id))
            else:
                unblock_batch_action_list.append((result.channel, result.read_id))

        if action in (Action.unblock, Action.stop_receiving):
            self.previous_action_tracker.add_action(result.channel, action)
            if self.chemistry is Chemistry.DUPLEX_SIMPLE:
                self.duplex_tracker.set_decision(result.channel, result.decision)
            elif self.chemistry is Chemistry.DUPLEX:
                self.duplex_tracker.set_decision(result.channel, result.decision)
                alignments = getattr(
                    result.alignment_data, "alignments", result.alignment_data
                ) or []
                self.duplex_tracker.set_alignments(
                    result.channel, [(al.ctg, al.strand) for al in alignments]
                )

        return (
            action,
            previous_action,
            action_overridden,
            action.name if action_overridden else None,
        )

    # ------------------------------------------------------------ hot loop --

    def run(self, max_iterations: int | None = None) -> None:
        """The hot loop (reference :447-586). max_iterations: test hook —
        None means run until the client stops sequencing."""
        if hasattr(self.client, "mk_run_dir"):
            self.conf.write_channels_toml(self.client.mk_run_dir)
        if hasattr(self.mapper, "describe"):
            self.logger.info(self.mapper.describe(
                getattr(self.conf, "regions", None),
                getattr(self.conf, "barcodes", None),
            ))
        loop_counter = 0
        last_live_toml_mtime = 0.0
        self.logger.info("Starting main loop")

        while self.client.is_sequencing:
            if max_iterations is not None and loop_counter >= max_iterations:
                break
            t0 = time.perf_counter()
            if self.wait_for_sequencing:
                time.sleep(self.throttle)
                continue
            self.log_once_in_loop = True
            if not getattr(self.mapper, "initialised", True):
                self.logger.warning("mapper not initialised yet; waiting")
                time.sleep(self.throttle)
                continue

            self.boss.reload()
            last_live_toml_mtime = self.reload_toml(last_live_toml_mtime)

            loop_counter += 1
            number_reads = 0
            unblock_batch_action_list: list = []
            stop_receiving_action_list: list = []

            chunks = self.client.get_read_chunks(
                getattr(self.client, "channel_count", 512), last=True
            )
            calls = self.caller.basecall(
                chunks,
                getattr(self.client, "signal_dtype", None),
                getattr(self.client, "calibration_values", None),
            )
            aligns = self.mapper.map_reads(calls)

            for result in aligns:
                number_reads += 1
                control, condition = self.conf.get_conditions(
                    result.channel, getattr(result, "barcode", None)
                )
                result.decision = self.boss.decide(result)
                action = condition.get_action(result.decision)
                seen_count = self.chunk_tracker.seen(result.channel, result.read_id)
                (
                    action,
                    previous_action,
                    action_overridden,
                    overridden_action_name,
                ) = self.check_override_action(
                    control,
                    action,
                    result,
                    seen_count,
                    condition,
                    stop_receiving_action_list,
                    unblock_batch_action_list,
                )
                region = self.conf.get_region(result.channel)
                self.loop_statistics.log_read(
                    client_iteration=loop_counter,
                    read_in_loop=number_reads,
                    read_id=result.read_id,
                    channel=result.channel,
                    seq_len=len(result.seq),
                    counter=seen_count,
                    mode=result.decision.name,
                    decision=action.name,
                    condition=condition.name,
                    barcode=getattr(result, "barcode", None),
                    previous_action=(
                        previous_action.name if previous_action is not None else None
                    ),
                    action_overridden=action_overridden,
                    timestamp=time.time(),
                    region_name=region.name if region is not None else "flowcell",
                    overridden_action_name=overridden_action_name,
                )

            self.client.unblock_read_batch(
                unblock_batch_action_list, duration=self.unblock_duration
            )
            self.client.stop_receiving_batch(stop_receiving_action_list)

            t1 = time.perf_counter()
            if number_reads > 0:
                self.loop_statistics.add_batch_performance(
                    number_of_reads=number_reads, batch_time=t1 - t0
                )
                self.logger.info(self.loop_statistics.get_batch_performance())
            if t0 + self.throttle > t1:
                time.sleep(self.throttle + t0 - t1)
        else:
            for plugin in (self.caller, self.mapper):
                disconnect = getattr(plugin, "disconnect", None)
                if disconnect is not None:
                    disconnect()
            self.logger.info("Finished analysis of reads as client stopped.")


# ---------------------------------------------------------------- CLI -------

def get_args(arg_list: list | None = None) -> tuple[argparse.ArgumentParser, argparse.Namespace]:
    """Build `readfish targets`-compatible args from (toml, device, name)
    (reference boss/_cli_base.py:18-67 + dynamic_readfish.py:276-307).

    Uses readfish's own parser when the package is importable (preserving its
    full plugin CLI surface); otherwise an equivalent in-repo parser.
    """
    arg_list = arg_list if arg_list is not None else sys.argv[1:]
    if len(arg_list) < 3:
        raise SystemExit("usage: readfish_boss.py <toml_readfish> <device> <name>")
    toml_readfish, device, name = arg_list[:3]
    argv = [
        "targets",
        "--toml", toml_readfish,
        "--device", device,
        "--experiment-name", name,
    ]
    try:  # prefer readfish's parser on sequencer hosts
        from boss._cli_base import main as rf_main  # type: ignore

        return rf_main(argv=argv)
    except ImportError:
        pass
    try:
        from readfish._cli_args import BASE_ARGS  # noqa: F401 readfish present?
        # readfish installed but without the BOSS fork: replicate _cli_base
        import importlib

        parser = argparse.ArgumentParser(prog="readfish", allow_abbrev=False)
        subparsers = parser.add_subparsers(dest="command")
        _module = importlib.import_module("readfish.entry_points.targets")
        _parser = subparsers.add_parser("targets", help=_module._help)
        for *flags, opts in _module._cli:
            _parser.add_argument(*flags, **opts)
        args, _ = parser.parse_known_args(argv)
        return parser, args
    except ImportError:
        pass
    # self-contained fallback: the option surface the loop consumes
    parser = argparse.ArgumentParser(prog="readfish_boss", allow_abbrev=False)
    parser.add_argument("command", choices=["targets"])
    parser.add_argument("--toml", required=True)
    parser.add_argument("--device", required=True)
    parser.add_argument("--experiment-name", dest="experiment_name", required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--throttle", type=float, default=0.4)
    parser.add_argument("--unblock-duration", dest="unblock_duration", type=float, default=0.1)
    parser.add_argument("--dry-run", dest="dry_run", action="store_true")
    parser.add_argument("--debug-log", dest="debug_log", default=None)
    parser.add_argument("--chemistry", default=Chemistry.SIMPLEX.value,
                        choices=[c.value for c in Chemistry])
    parser.add_argument("--wait-for-ready", dest="wait_for_ready", type=int, default=120)
    parser.add_argument("--max-unblock-read-length-seconds", type=float, default=0)
    parser.add_argument("--padding", type=int, default=None)
    args = parser.parse_args(argv)
    return parser, args


def _warn_minknow_compatibility(run_logger: logging.Logger, args) -> None:
    """MinKNOW version gates (reference readfish_boss.py:607-630): warn when
    the connected MinKNOW is outside readfish's tested compatibility range,
    and hard-exit below v6 (the reference's critical gate). Uses readfish's
    own helpers when available; silently skips if they are not (the fake
    test path), matching the reference's sequencer-host-only check."""
    try:
        from packaging.version import Version  # type: ignore
        from readfish._utils import (  # type: ignore
            DIRECTION,
            MINKNOW_COMPATIBILITY_RANGE,
            check_compatibility,
            get_minknow_version,
        )
    except ImportError:
        return
    try:
        minknow_version = get_minknow_version(host=args.host, port=getattr(args, "port", None))
    except Exception as e:  # noqa: BLE001 - version probe must never kill the run
        run_logger.warning(f"could not determine MinKNOW version: {e}")
        return
    action = check_compatibility(minknow_version, MINKNOW_COMPATIBILITY_RANGE)
    if action in (DIRECTION.UPGRADE, DIRECTION.DOWNGRADE):
        lower_bound, upper_bound = MINKNOW_COMPATIBILITY_RANGE
        run_logger.warning(
            f"This readfish_boss build is tested for compatibility with "
            f"MinKNOW v{lower_bound} to v{upper_bound}; this MinKNOW is "
            f"{minknow_version}. If the run fails, try to {action.value} "
            f"readfish."
        )
    if minknow_version < Version("6.0.0"):
        run_logger.critical(
            f"MinKNOW {minknow_version} is not supported (requires >= 6.0); "
            "exiting."
        )
        raise SystemExit(1)


def run(parser, args, extras) -> int | tuple:
    """Entry-point runner (reference readfish_boss.py:590-712): version gate,
    Read Until client, conf load, Analysis. `args.return_conf` returns
    (conf, logger) before touching hardware — the unit-test hook."""
    run_logger = logging.getLogger(f"readfish.{getattr(args, 'command', 'targets')}")

    conf = RFConf.from_file(args.toml)
    if getattr(args, "return_conf", False):
        return conf, run_logger

    # everything below needs the sequencer stack
    try:
        from minknow_api.manager import Manager  # noqa: F401
        from read_until import AccumulatingCache  # type: ignore  # noqa: F401
        from readfish._utils import get_device  # type: ignore
        from readfish.read_until.base import ReadUntilClient  # type: ignore
    except ImportError as e:
        raise SystemExit(
            f"readfish/minknow_api are required for live operation ({e}); "
            "this loop is unit-testable via Analysis(client=fake, ...)"
        )

    _warn_minknow_compatibility(run_logger, args)

    position = get_device(args.device, host=args.host, port=args.port)
    read_until_client = ReadUntilClient(
        mk_host=position.host,
        mk_port=position.description.rpc_ports.secure,
        filter_strands=True,
        cache_type=AccumulatingCache,
    )
    conf = RFConf.from_file(args.toml, read_until_client.channel_count)
    read_until_client.run(
        first_channel=1, last_channel=read_until_client.channel_count
    )
    worker = Analysis(
        read_until_client,
        conf=conf,
        logger=run_logger,
        debug_log=getattr(args, "debug_log", None),
        unblock_duration=getattr(args, "unblock_duration", 0.1),
        throttle=getattr(args, "throttle", 0.4),
        dry_run=getattr(args, "dry_run", False),
        toml=args.toml,
        chemistry=Chemistry(getattr(args, "chemistry", "simplex")),
    )
    try:
        worker.run()
    except KeyboardInterrupt:
        run_logger.info("Keyboard interrupt received, stopping readfish.")
    finally:
        read_until_client.reset()
    return 0


def main(argv=None) -> int:
    """python -m bossruns_tpu.live.readfish_boss <toml> <device> <name>
    (reference :716-731: dummy index first, then args -> run)."""
    BossBits.gen_dummy_idx()
    parser, args = get_args(argv)
    out = run(parser=parser, args=args, extras=[])
    return out if isinstance(out, int) else 0


if __name__ == "__main__":
    sys.exit(main())
