"""`weed` CLI: subcommand surface of the reference binary.

Behavioral model: weed/command/ — server, master, volume, filer, s3,
shell, benchmark, upload, download, filer.copy, filer.cat,
filer.meta.tail, backup, compact, fix, export, scaffold, version, mount,
webdav, msgBroker.

The port's copy of ``seaweedfs_tpu/command/cli.py``, run as
``python -m seaweedfs_tpu_torch <subcommand>``: the same subcommands,
flags, defaults and output text, with one addition. ``volume`` and
``server`` take ``-device`` (default ``cuda``) and hand it to
``VolumeServer(device=)``; with no card they raise unless the flag says
``cpu``, never falling back on their own. ``benchmark -fleet`` and
``scale`` build their fleets on the card. ``filer`` and ``server
-filer`` start the port's filer, ``s3`` and ``server -s3`` its S3
gateway, ``filer.sync`` and ``filer.replicate`` its replication,
``webdav`` its WebDAV gateway, ``mount`` its FUSE mount and
``msgBroker`` its message broker; these client-side subcommands import
no torch.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

from .. import __version__


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(
        prog="weed", description="seaweedfs-tpu: TPU-native SeaweedFS"
    )
    sub = p.add_subparsers(dest="cmd")

    sp = sub.add_parser("version")

    sp = sub.add_parser("master", help="start a master server")
    sp.add_argument("-ip", default="127.0.0.1")
    sp.add_argument("-port", type=int, default=9333)
    sp.add_argument("-volumeSizeLimitMB", type=int, default=30_000)
    sp.add_argument("-mdir", default="",
                    help="directory for durable master/raft state")
    sp.add_argument("-defaultReplication", default="000")
    sp.add_argument("-garbageThreshold", type=float, default=0.3)
    sp.add_argument("-peers", default="",
                    help="comma-separated peer master host:ports")
    sp.add_argument(
        "-maintenance", action="store_true",
        help="enable the autonomous maintenance plane (vacuum / EC "
             "encode / shard rebuild / replica repair / balance); "
             "knobs via SEAWEEDFS_MAINT_* env",
    )
    sp.add_argument(
        "-maintenance.interval", dest="maintenance_interval",
        default="", help='detector round cadence, e.g. "30s", "5m"',
    )

    sp = sub.add_parser("volume", help="start a volume server")
    sp.add_argument("-ip", default="127.0.0.1")
    sp.add_argument("-port", type=int, default=8080)
    sp.add_argument("-mserver", default="127.0.0.1:9333")
    sp.add_argument("-dir", default="./data")
    sp.add_argument("-max", type=int, default=7)
    sp.add_argument("-index", default="memory",
                    choices=("memory", "sqlite"),
                    help="needle map kind (reference -index=memory|leveldb)")
    sp.add_argument("-dataCenter", default="")
    sp.add_argument("-rack", default="")
    sp.add_argument("-publicUrl", default="")
    sp.add_argument(
        "-largeDisk", action="store_true",
        help="5-byte idx offsets: volumes up to 8 TB instead of "
        "32 GiB (reference 5BytesOffset build tag)",
    )
    sp.add_argument("-device", default="cuda",
                    help="where the EC codec runs: cuda (a card must be "
                    "present) or cpu (the kernels' plain versions)")

    sp = sub.add_parser("filer", help="start a filer server")
    sp.add_argument("-ip", default="127.0.0.1")
    sp.add_argument("-port", type=int, default=8888)
    sp.add_argument("-master", default="127.0.0.1:9333")
    sp.add_argument("-collection", default="")
    sp.add_argument("-replication", default="")
    sp.add_argument("-store", default="memory",
                    choices=("memory", "sqlite", "lsm"))
    sp.add_argument("-dbPath", default="filer.db")
    sp.add_argument(
        "-shard", default="",
        help="this filer's slot in a sharded metadata tier, as i/N "
        "(e.g. 0/4); each shard owns a hash partition of the namespace",
    )

    sp = sub.add_parser("s3", help="start an S3 gateway")
    sp.add_argument("-port", type=int, default=8333)
    sp.add_argument("-filer", default="127.0.0.1:8888")
    sp.add_argument("-config", default="",
                    help="json identities config")

    sp = sub.add_parser("webdav", help="start a WebDAV gateway")
    sp.add_argument("-port", type=int, default=7333)
    sp.add_argument("-filer", default="127.0.0.1:8888")

    sp = sub.add_parser(
        "server", help="master + volume (+filer +s3) in one process"
    )
    sp.add_argument("-ip", default="127.0.0.1")
    sp.add_argument("-dir", default="./data")
    sp.add_argument("-master.port", dest="master_port", type=int,
                    default=9333)
    sp.add_argument("-volume.port", dest="volume_port", type=int,
                    default=8080)
    sp.add_argument("-volume.max", dest="volume_max", type=int,
                    default=7)
    sp.add_argument("-filer", action="store_true")
    sp.add_argument("-filer.port", dest="filer_port", type=int,
                    default=8888)
    sp.add_argument("-s3", action="store_true")
    sp.add_argument("-s3.port", dest="s3_port", type=int, default=8333)
    sp.add_argument("-device", default="cuda",
                    help="where the volume server's EC codec runs: cuda "
                    "or cpu")

    sp = sub.add_parser("shell", help="interactive admin shell")
    sp.add_argument("-master", default="127.0.0.1:9333")
    sp.add_argument("-c", dest="script", default="",
                    help="run commands separated by ';' and exit")

    sp = sub.add_parser(
        "benchmark",
        help="workload generator: mixed/zipfian load benchmark",
    )
    sp.add_argument("-master", default="127.0.0.1:9333")
    sp.add_argument("-n", type=int, default=1000)
    sp.add_argument("-size", type=int, default=1024)
    sp.add_argument("-sizes", default="",
                    help='variable object sizes, e.g. "512-4096" '
                         "(overrides -size)")
    sp.add_argument("-c", dest="concurrency", type=int, default=16)
    sp.add_argument("-collection", default="benchmark")
    sp.add_argument("-write", action="store_true", default=None)
    sp.add_argument("-read", action="store_true", default=None)
    sp.add_argument("-mix", default="",
                    help='mixed op workload, e.g. '
                         '"write:30,read:60,delete:10" (one steady '
                         "phase instead of write-then-read)")
    sp.add_argument("-zipf", dest="zipf_s", type=float, default=1.1,
                    help="zipf exponent for key popularity "
                         "(reads/deletes hit hot keys)")
    sp.add_argument("-warmup", type=int, default=0,
                    help="unrecorded warmup ops before each phase")
    sp.add_argument("-duration", type=float, default=0.0,
                    help="steady-state seconds per phase "
                         "(replaces -n)")
    sp.add_argument("-seed", type=int, default=0,
                    help="seeds every RNG (payloads, sizes, op "
                         "choice, key sampling)")
    sp.add_argument("-replication", default="",
                    help='replica placement for writes, e.g. "010"')
    sp.add_argument("-assignBatch", dest="assign_batch", type=int,
                    default=1,
                    help="pre-assign fids in batches of N (one "
                         "/dir/assign?count=N per N writes)")
    sp.add_argument("-personas", default="",
                    help="concurrent multi-protocol personas, e.g. "
                         '"native:40,s3:30,fuse:20,broker:10" — '
                         "drives every front door of one fleet with "
                         "per-protocol golden signals in "
                         "detail.protocols (overrides -mix)")
    sp.add_argument("-filerUrl", dest="filer_url", default="",
                    help="existing filer for the fuse persona "
                         "(spawned in-proc when personas need one)")
    sp.add_argument("-s3Url", dest="s3_url", default="",
                    help="existing S3 gateway for the s3 persona "
                         "(spawned in-proc when missing)")
    sp.add_argument("-brokerUrl", dest="broker_url", default="",
                    help="existing message broker for the broker "
                         "persona (spawned in-proc when missing)")
    sp.add_argument("-fleet", type=int, default=0,
                    help="spawn an in-proc fleet of N volume servers "
                         "and run against it (reproducible LOAD "
                         "recording without an external cluster)")
    sp.add_argument("-json", "--json", dest="json_path", default="",
                    help="write the LOAD_rNN.json round record")
    sp.add_argument("-check", "--check", dest="check_path", default="",
                    help="gate this run against a stored LOAD round; "
                         "exit 1 on regression")
    sp.add_argument("-checkThreshold", "--check-threshold",
                    dest="check_threshold", type=float, default=None,
                    help="relative regression threshold (default 0.2)")
    sp.add_argument("-checkResult", "--check-result",
                    dest="check_result", default="",
                    help="gate a STORED result file instead of "
                         "running (needs -check)")

    sp = sub.add_parser("upload", help="upload files")
    sp.add_argument("-master", default="127.0.0.1:9333")
    sp.add_argument("-collection", default="")
    sp.add_argument("-replication", default="")
    sp.add_argument("-maxMB", type=int, default=4,
                    help="split files larger than this into chunks "
                         "(operation/submit.go auto-split)")
    sp.add_argument("files", nargs="+")

    sp = sub.add_parser("download", help="download files by fid")
    sp.add_argument("-master", default="127.0.0.1:9333")
    sp.add_argument("-dir", default=".")
    sp.add_argument("fids", nargs="+")

    sp = sub.add_parser("filer.copy", help="copy local files to filer")
    sp.add_argument("-filer", default="127.0.0.1:8888")
    sp.add_argument("files", nargs="+")
    sp.add_argument("dest", help="filer destination folder")

    sp = sub.add_parser("filer.cat", help="print a filer file")
    sp.add_argument("-filer", default="127.0.0.1:8888")
    sp.add_argument("path")

    sp = sub.add_parser("filer.meta.tail", help="stream filer meta events")
    sp.add_argument("-filer", default="127.0.0.1:8888")
    sp.add_argument("-pollSeconds", type=float, default=1.0)

    sp = sub.add_parser("fix", help="rebuild .idx from a .dat volume")
    sp.add_argument("-dir", default=".")
    sp.add_argument("-collection", default="")
    sp.add_argument("-volumeId", type=int, required=True)

    sp = sub.add_parser("compact", help="offline-vacuum a volume")
    sp.add_argument("-dir", default=".")
    sp.add_argument("-collection", default="")
    sp.add_argument("-volumeId", type=int, required=True)

    sp = sub.add_parser("export", help="export volume needles to files")
    sp.add_argument("-dir", default=".")
    sp.add_argument("-collection", default="")
    sp.add_argument("-volumeId", type=int, required=True)
    sp.add_argument("-o", dest="output", default="./export")

    sp = sub.add_parser(
        "backup", help="incrementally back up a remote volume"
    )
    sp.add_argument("-server", required=True)
    sp.add_argument("-dir", default=".")
    sp.add_argument("-collection", default="")
    sp.add_argument("-volumeId", type=int, required=True)

    sp = sub.add_parser("scaffold", help="print config templates")
    sp.add_argument("-config", default="filer",
                    choices=("filer", "master", "security",
                             "replication", "shell", "backend"))

    sp = sub.add_parser("mount", help="FUSE-mount a filer (needs libfuse)")
    sp.add_argument("-filer", default="127.0.0.1:8888")
    sp.add_argument("-dir", required=True)
    sp.add_argument("-filer.path", dest="filer_path", default="/")

    sp = sub.add_parser("msgBroker", help="start a message broker")
    sp.add_argument("-port", type=int, default=17777)
    sp.add_argument("-filer", default="127.0.0.1:8888")
    sp.add_argument("-master", default="",
                    help="master URL to push broker telemetry to "
                         "(joins /cluster/telemetry like filer/S3)")

    sp = sub.add_parser(
        "filer.sync", help="bidirectional sync between two filers"
    )
    sp.add_argument("-a", required=True, help="filer A host:port")
    sp.add_argument("-b", required=True, help="filer B host:port")
    sp.add_argument("-oneWay", action="store_true")
    sp.add_argument("-pollSeconds", type=float, default=1.0)

    sp = sub.add_parser(
        "filer.replicate",
        help="replicate filer meta events to a sink",
    )
    sp.add_argument("-filer", required=True, help="source filer")
    sp.add_argument("-sink.filer", dest="sink_filer", default="")
    sp.add_argument("-sink.dir", dest="sink_dir", default="")
    sp.add_argument("-sourcePath", default="/")
    sp.add_argument("-sinkPath", default="/")
    sp.add_argument("-pollSeconds", type=float, default=1.0)

    sp = sub.add_parser(
        "scale",
        help="in-process scale scenario: spawn a fleet, churn it "
             "under load, time the self-heal (SCALE_rNN.json)",
    )
    sp.add_argument("-spec", default="5x4x5",
                    help='topology "DCSxRACKSxSERVERS[mMASTERS][fSHARDS]" '
                         "(5x4x5 = 100 servers; 5x4x5m3 adds a "
                         "3-master raft tier; 5x4x5m3f4 adds a "
                         "4-shard filer metadata tier)")
    sp.add_argument("-seed", type=int, default=1,
                    help="seeds churn targets and the load workload")
    sp.add_argument("-pulse", type=float, default=0.5,
                    help="heartbeat pulse seconds")
    sp.add_argument("-churn", default="flat",
                    help="churn kind: flat | burst | rolling | warm "
                         "| leader (warm seeds full volumes the "
                         "maintenance plane must EC-encode under "
                         "churn; leader kills the raft leader "
                         "mid-ingest — forces >= 3 masters)")
    sp.add_argument("-masters", type=int, default=0,
                    help="master-tier size (0 = spec default; "
                         ">= 3 spawns a raft cluster)")
    sp.add_argument("-killFraction", dest="kill_fraction",
                    type=float, default=0.1,
                    help="fraction of servers to lose (stay dead)")
    sp.add_argument("-loadSeconds", dest="load_seconds",
                    type=float, default=6.0)
    sp.add_argument("-personas", default="",
                    help="run the multi-protocol persona mix as the "
                         "round's load (weed benchmark -personas "
                         "syntax); per-protocol rates land in the "
                         "round's detail.protocols")
    sp.add_argument("-replication", default="000")
    sp.add_argument("-convergeTimeout", dest="converge_timeout",
                    type=float, default=120.0)
    sp.add_argument("-record-hz", "--record-hz", dest="record_hz",
                    type=float, default=2.0,
                    help="flight-recorder sampling rate for the "
                         "round's timeline/contention sections "
                         "(0 disables)")
    sp.add_argument("-json", "--json", dest="json_path", default="",
                    help="write the SCALE_rNN.json round record")
    sp.add_argument("-check", "--check", dest="check_path", default="",
                    help="gate against a stored SCALE round; "
                         "exit 1 on regression")
    sp.add_argument("-checkThreshold", "--check-threshold",
                    dest="check_threshold", type=float, default=None)

    sp = sub.add_parser(
        "trends",
        help="cross-round trajectory: sparkline every recorded "
             "*_rNN.json metric by kind, flag multi-round drift",
    )
    sp.add_argument("-dir", default=".",
                    help="directory holding the round files")
    sp.add_argument("-check", "--check", dest="check",
                    action="store_true",
                    help="exit 1 when any metric series drifts "
                         "(>=3-round decay streak, or cumulative "
                         "decline past the threshold since the best "
                         "round)")
    sp.add_argument("-checkThreshold", "--check-threshold",
                    dest="check_threshold", type=float, default=None,
                    help="cumulative drift threshold (default 0.2)")

    args = p.parse_args(argv)
    if args.cmd is None:
        p.print_help()
        return 1
    return globals()[f"run_{args.cmd.replace('.', '_')}"](args)


def _wait_forever():
    try:
        signal.pause()
    except (KeyboardInterrupt, AttributeError):
        pass
    return 0


def run_version(args) -> int:
    print(f"seaweedfs-tpu version {__version__}")
    return 0


def _security_key() -> str:
    from ..util.config import Configuration

    return Configuration.load("security").get_string("jwt_signing_key")


def _tls_contexts():
    """(server_ctx, configured) from security.{json,toml}: the tls.go
    model — when cert paths are configured, servers listen with mTLS
    and the process's outbound cluster clients present the client
    cert. Returns (None, False) when TLS is not configured."""
    from ..util.config import Configuration

    cfg = Configuration.load("security")
    ca = cfg.get_string("tls_ca")
    cert = cfg.get_string("tls_cert")
    key = cfg.get_string("tls_key")
    if not (ca and cert and key):
        return None, False
    from ..security import tls as tls_mod
    from ..util import http as http_mod

    http_mod.configure_client_tls(
        tls_mod.client_context(ca, cert, key)
    )
    return tls_mod.server_context(cert, key, ca), True


def run_master(args) -> int:
    from ..maintenance import MaintenancePolicy, parse_duration
    from ..server.master import MasterServer

    peers = [p for p in args.peers.split(",") if p]
    ssl_ctx, _ = _tls_contexts()
    maint_overrides: dict = {}
    if args.maintenance:
        maint_overrides["enabled"] = True
    if args.maintenance_interval:
        maint_overrides["interval"] = parse_duration(
            args.maintenance_interval
        )
    maintenance_policy = (
        MaintenancePolicy.from_env(**maint_overrides)
        if maint_overrides else None
    )
    m = MasterServer(
        host=args.ip,
        port=args.port,
        volume_size_limit_mb=args.volumeSizeLimitMB,
        default_replication=args.defaultReplication,
        garbage_threshold=args.garbageThreshold,
        peers=peers,
        jwt_signing_key=_security_key(),
        ssl_context=ssl_ctx,
        state_dir=args.mdir or None,
        maintenance_policy=maintenance_policy,
    )
    m.start()
    print(f"master listening on {m.url}")
    return _wait_forever()


def run_volume(args) -> int:
    from ..server.volume import VolumeServer

    if args.largeDisk:
        from ..storage import types as storage_types

        storage_types.set_offset_size(5)
    dirs = args.dir.split(",")
    maxes = [args.max] * len(dirs)
    # -mserver accepts a comma-separated master list (volume.go analog);
    # the first is the initial home, the rest are failover peers
    masters = [m for m in args.mserver.split(",") if m]
    vs = VolumeServer(
        master_url=masters[0],
        dirs=dirs,
        max_volume_counts=maxes,
        master_peers=masters,
        host=args.ip,
        port=args.port,
        public_url=args.publicUrl,
        data_center=args.dataCenter,
        rack=args.rack,
        jwt_signing_key=_security_key(),
        needle_map_kind=args.index,
        ssl_context=_tls_contexts()[0],
        device=args.device,
    )
    vs.start()
    print(f"volume server listening on {vs.url}")
    return _wait_forever()


def run_filer(args) -> int:
    from ..filer import (
        LogStructuredStore,
        MemoryStore,
        SqliteStore,
    )
    from ..server.filer import FilerServer

    shard = None
    if args.shard:
        try:
            idx_s, of_s = args.shard.split("/", 1)
            shard = (int(idx_s), int(of_s))
        except ValueError:
            print(f"bad -shard {args.shard!r}: want i/N (e.g. 0/4)")
            return 1
        if not (0 <= shard[0] < shard[1] <= 64):
            print(f"bad -shard {args.shard!r}: need 0 <= i < N <= 64")
            return 1
    if args.store == "sqlite":
        store = SqliteStore(args.dbPath)
    elif args.store == "lsm":
        store = LogStructuredStore(args.dbPath + ".lsm")
    else:
        store = MemoryStore()
    # durable stores get a durable event log beside the db so sync peers
    # survive a filer restart (filer_notify.go analog)
    meta_log_dir = (
        args.dbPath + ".metalog"
        if args.store in ("sqlite", "lsm")
        else None
    )
    fs = FilerServer(
        args.master,
        host=args.ip,
        port=args.port,
        store=store,
        collection=args.collection,
        replication=args.replication,
        jwt_signing_key=_security_key(),
        meta_log_dir=meta_log_dir,
        shard=shard,
        ssl_context=_tls_contexts()[0],
    )
    fs.start()
    if shard is not None:
        print(f"filer shard {shard[0]}/{shard[1]} listening on {fs.url}")
        return _wait_forever()
    print(f"filer listening on {fs.url}")
    return _wait_forever()


def run_s3(args) -> int:
    from ..s3 import S3ApiServer
    from ..s3.auth import Identity

    identities = []
    if args.config:
        with open(args.config) as f:
            for ident in json.load(f).get("identities", []):
                identities.append(
                    Identity(
                        name=ident["name"],
                        access_key=ident["credentials"][0]["accessKey"],
                        secret_key=ident["credentials"][0]["secretKey"],
                        actions=ident.get("actions", ["Admin"]),
                    )
                )
    s3 = S3ApiServer(
        args.filer, port=args.port, identities=identities,
        ssl_context=_tls_contexts()[0],
    )
    s3.start()
    print(f"s3 gateway listening on {s3.url}")
    return _wait_forever()


def run_webdav(args) -> int:
    from ..server.webdav import WebDavServer

    w = WebDavServer(
        args.filer, port=args.port, ssl_context=_tls_contexts()[0]
    )
    w.start()
    print(f"webdav listening on {w.url}")
    return _wait_forever()


def run_server(args) -> int:
    from ..server.master import MasterServer
    from ..server.volume import VolumeServer

    from .. import resolve_device

    # the card is checked before the master starts: a server that
    # cannot run leaves no master behind
    resolve_device(args.device)
    ssl_ctx_factory = lambda: _tls_contexts()[0]  # noqa: E731
    m = MasterServer(
        host=args.ip, port=args.master_port,
        ssl_context=ssl_ctx_factory(),
    )
    m.start()
    vs = VolumeServer(
        master_url=m.url,
        dirs=[args.dir],
        max_volume_counts=[args.volume_max],
        host=args.ip,
        port=args.volume_port,
        ssl_context=ssl_ctx_factory(),
        device=args.device,
    )
    vs.start()
    print(f"master on {m.url}, volume server on {vs.url}")
    if args.filer or args.s3:
        from ..server.filer import FilerServer

        fs = FilerServer(
            m.url, host=args.ip, port=args.filer_port,
            ssl_context=ssl_ctx_factory(),
        )
        fs.start()
        print(f"filer on {fs.url}")
        if args.s3:
            from ..s3 import S3ApiServer

            s3 = S3ApiServer(
                fs.url, port=args.s3_port,
                ssl_context=ssl_ctx_factory(),
            )
            s3.start()
            print(f"s3 on {s3.url}")
    return _wait_forever()


def run_shell(args) -> int:
    from ..shell import CommandEnv, run_command

    _tls_contexts()  # configure outbound mTLS for a secured cluster
    env = CommandEnv(args.master)
    if args.script:
        for line in args.script.split(";"):
            out = run_command(env, line.strip())
            if out:
                print(out, end="")
        env.unlock()
        return 0
    print("seaweedfs-tpu shell; 'help' lists commands, 'exit' quits")
    while True:
        try:
            line = input("> ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if line in ("exit", "quit"):
            break
        if not line:
            continue
        try:
            print(run_command(env, line), end="")
        except Exception as e:
            print(f"error: {e}")
    env.unlock()
    return 0


def run_benchmark(args) -> int:
    from . import benchmark as bench_mod

    if args.check_result:
        if not args.check_path:
            print("-checkResult needs -check <baseline>",
                  file=sys.stderr)
            return 2
        from ..util import benchgate

        return bench_mod.run_check(
            benchgate.load_round(args.check_result),
            args.check_path,
            args.check_threshold,
        )

    def run_against(master_url: str) -> int:
        return bench_mod.run_benchmark(
            master_url,
            n=args.n,
            size=args.size,
            concurrency=args.concurrency,
            collection=args.collection,
            do_write=args.write is not False,
            do_read=args.read is not False,
            mix=args.mix,
            sizes=args.sizes,
            zipf_s=args.zipf_s,
            warmup=args.warmup,
            duration=args.duration,
            seed=args.seed,
            replication=args.replication,
            assign_batch=args.assign_batch,
            personas=args.personas,
            filer_url=args.filer_url,
            s3_url=args.s3_url,
            broker_url=args.broker_url,
            json_path=args.json_path,
            check_path=args.check_path,
            check_threshold=args.check_threshold,
        )

    if args.fleet > 0:
        # self-contained run: spawn an in-proc fleet, benchmark it,
        # tear it down — LOAD rounds record reproducibly without an
        # external cluster (the nightly's persona stage runs this way)
        from ..server.harness import ClusterHarness

        with ClusterHarness(
            n_volume_servers=args.fleet, volumes_per_server=30
        ) as c:
            c.wait_for_nodes(args.fleet)
            return run_against(c.master.url)
    return run_against(args.master)


def run_scale(args) -> int:
    from ..scale import round as scale_round

    result = scale_round.run_scale_round(
        spec=args.spec,
        seed=args.seed,
        pulse_seconds=args.pulse,
        churn_kind=args.churn,
        masters=args.masters or None,
        kill_fraction=args.kill_fraction,
        load_seconds=args.load_seconds,
        personas=args.personas,
        replication=args.replication,
        converge_timeout=args.converge_timeout,
        record_hz=args.record_hz,
        json_path=args.json_path,
        check_path=args.check_path,
        check_threshold=args.check_threshold,
    )
    if not result["detail"]["converged"]:
        return 1
    return int(result.get("check_rc", 0))


def run_trends(args) -> int:
    from ..telemetry import trajectory

    return trajectory.run_trends(
        dir_path=args.dir,
        check=args.check,
        threshold=args.check_threshold,
    )


def run_upload(args) -> int:
    from ..operation.submit import submit_files

    for result in submit_files(
        args.master,
        args.files,
        collection=args.collection,
        replication=args.replication,
        max_mb=args.maxMB,
    ):
        print(json.dumps(result))
    return 0


def run_download(args) -> int:
    from .. import operation

    for fid in args.fids:
        data = operation.read_file(args.master, fid)
        out = os.path.join(args.dir, fid.replace(",", "_"))
        with open(out, "wb") as f:
            f.write(data)
        print(f"{fid} -> {out} ({len(data)} bytes)")
    return 0


def run_filer_copy(args) -> int:
    from ..util import http

    for path in args.files:
        with open(path, "rb") as f:
            data = f.read()
        dest = args.dest.rstrip("/") + "/" + os.path.basename(path)
        http.request("POST", f"{args.filer}{dest}", data)
        print(f"{path} -> {dest}")
    return 0


def run_filer_cat(args) -> int:
    from ..util import http

    sys.stdout.buffer.write(
        http.request("GET", f"{args.filer}{args.path}")
    )
    return 0


def run_filer_meta_tail(args) -> int:
    from ..util import http, retry

    since = 0
    # foreground CLI poll loop: Ctrl-C is the stop signal
    while True:  # weedcheck: ignore[loop-without-stop]
        out = http.get_json(
            f"{args.filer}/meta/events?since={since}",
            retry=retry.LOOKUP,
        )
        for ev in out.get("events", []):
            since = max(since, ev["ts_ns"])
            print(json.dumps(ev))
        time.sleep(args.pollSeconds)


def _volume_base(args) -> str:
    name = (
        f"{args.collection}_{args.volumeId}"
        if args.collection
        else str(args.volumeId)
    )
    return os.path.join(args.dir, name)


def _adopt_volume_offset_width(base: str) -> None:
    """Offline tools (fix/compact/export) operate at whatever idx
    offset width the volume was written with — recorded in its .vif —
    regardless of this process's default; a rebuild at the wrong
    width would corrupt the index."""
    from ..storage import backend as backend_mod
    from ..storage import types as t

    t.set_offset_size(backend_mod.volume_offset_width(base))


def run_fix(args) -> int:
    """Rebuild .idx by scanning the .dat (weed/command/fix.go:40-61)."""
    from ..storage import needle as needle_mod
    from ..storage import super_block as sb_mod
    from ..storage import types as t

    base = _volume_base(args)
    _adopt_volume_offset_width(base)
    # streaming header walk (fix.go scans, never slurps): memory stays
    # O(needles), not O(dat) — large-disk volumes reach 8 TB
    dat_size = os.path.getsize(base + ".dat")
    entries: dict[int, tuple[int, int]] = {}
    with open(base + ".dat", "rb") as f:
        sb = sb_mod.SuperBlock.from_bytes(f.read(8))
        offset = sb.block_size
        while offset + t.NEEDLE_HEADER_SIZE <= dat_size:
            f.seek(offset)
            n = needle_mod.Needle.parse_header(
                f.read(t.NEEDLE_HEADER_SIZE)
            )
            total = needle_mod.get_actual_size(n.size, sb.version)
            if offset + total > dat_size:
                break
            if n.size > 0:
                entries[n.id] = (offset, n.size)
            else:
                entries.pop(n.id, None)
            offset += total
    with open(base + ".idx", "wb") as f:
        for key, (off, size) in entries.items():
            f.write(t.pack_idx_entry(key, off, size))
    print(f"rebuilt {base}.idx with {len(entries)} entries")
    return 0


def run_compact(args) -> int:
    from ..storage.volume import Volume

    _adopt_volume_offset_width(_volume_base(args))
    v = Volume(args.dir, args.collection, args.volumeId)
    v.compact()
    v.commit_compact()
    v.close()
    print(f"compacted volume {args.volumeId}")
    return 0


def run_export(args) -> int:
    from ..storage import types as t
    from ..storage.volume import Volume

    _adopt_volume_offset_width(_volume_base(args))
    v = Volume(args.dir, args.collection, args.volumeId)
    os.makedirs(args.output, exist_ok=True)
    count = 0
    for key, nv in v.nm.ascending_visit():
        if not t.size_is_valid(nv.size):
            continue
        n = v.read_needle(key)
        name = (
            n.name.decode("utf8", "replace")
            if n.name
            else f"{key:x}"
        )
        out = os.path.join(args.output, name)
        with open(out, "wb") as f:
            f.write(n.data)
        count += 1
    v.close()
    print(f"exported {count} files to {args.output}")
    return 0


def run_backup(args) -> int:
    """Incremental volume backup via the tail API (volume_backup.go)."""
    from ..storage.volume_backup import incremental_backup

    os.makedirs(args.dir, exist_ok=True)
    added = incremental_backup(
        args.dir, args.collection, args.volumeId, args.server
    )
    print(f"backed up volume {args.volumeId}: {added} new bytes")
    return 0


SCAFFOLDS = {
    "filer": '{\n  "store": "sqlite",\n  "dbPath": "filer.db"\n}\n',
    "master": '{\n  "volumeSizeLimitMB": 30000,\n'
    '  "defaultReplication": "000",\n  "garbageThreshold": 0.3\n}\n',
    "security": '{\n  "jwt_signing_key": "",\n  "white_list": [],\n'
    '  "tls_ca": "",\n  "tls_cert": "",\n  "tls_key": ""\n}\n',
    "replication": '{\n  "source": {"filer": "localhost:8888"},\n'
    '  "sink": {"filer": "localhost:8889"}\n}\n',
    "shell": '{\n  "master": "localhost:9333"\n}\n',
    # named cloud-tier backends (backend.toml analog): credentials
    # live here, never in per-volume .vif files
    "backend": '{\n  "s3": {\n    "default": {\n'
    '      "endpoint": "s3.example.com",\n'
    '      "access_key": "",\n      "secret_key": ""\n    }\n  }\n}\n',
}


def run_scaffold(args) -> int:
    print(SCAFFOLDS[args.config], end="")
    return 0


def run_mount(args) -> int:
    _tls_contexts()  # outbound mTLS when the cluster is secured

    from ..mount import mount_filer

    return mount_filer(args.filer, args.dir, args.filer_path)


def run_filer_sync(args) -> int:
    from ..replication import FilerSync

    sync = FilerSync(
        args.a, args.b,
        bidirectional=not args.oneWay,
        poll_seconds=args.pollSeconds,
    )
    sync.start()
    print(f"syncing {args.a} <-> {args.b}")
    return _wait_forever()


def run_filer_replicate(args) -> int:
    from ..replication import Replicator
    from ..replication.sink import FilerSink, LocalSink
    from ..util import http as _http

    if args.sink_filer:
        sink = FilerSink(args.sink_filer)
    elif args.sink_dir:
        sink = LocalSink(args.sink_dir)
    else:
        print("need -sink.filer or -sink.dir", file=sys.stderr)
        return 1
    rep = Replicator(args.filer, sink, args.sourcePath, args.sinkPath)
    print(f"replicating {args.filer}{args.sourcePath} -> sink")
    from ..util import retry as _retry

    since = 0
    # foreground CLI poll loop: Ctrl-C is the stop signal
    while True:  # weedcheck: ignore[loop-without-stop]
        out = _http.get_json(
            f"{args.filer}/meta/events?since={since}",
            retry=_retry.LOOKUP,
        )
        for ev in out.get("events", []):
            since = max(since, ev["ts_ns"])
            rep.replicate_event(ev)
        time.sleep(args.pollSeconds)


def run_msgBroker(args) -> int:
    from ..messaging.broker import MessageBroker

    b = MessageBroker(args.filer, port=args.port,
                      master_url=args.master)
    b.start()
    print(f"message broker listening on {b.url}")
    return _wait_forever()


if __name__ == "__main__":
    sys.exit(main())
