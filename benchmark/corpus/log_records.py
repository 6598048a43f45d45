"""Service logs: Loghub-style lines from a few templates.

A stand-in for Loghub (Zhu et al., "Loghub: A Large Collection of System
Log Datasets", ISSRE 2023), which cannot be fetched here.  The templates
follow the shapes of its HDFS, Hadoop, Spark, Zookeeper, OpenStack and BGL
logs.  `layout`, the same for every seed, ranks the templates and fills
the pools of block ids, addresses, request ids and nodes; the run's seed
draws each line: a template with Zipf weights over those ranks,
timestamps that increase by exponential gaps, pool entries and levels
with Zipf weights; sizes, ports and counters vary, so the lines vary in
length.  Every number is a parameter of the traffic file (`params`)."""

import time

import numpy as np

LEVELS = ("INFO", "WARN", "DEBUG", "ERROR", "FATAL")

TEMPLATES = (
    "{ts} {lvl} dfs.DataNode$PacketResponder: PacketResponder {d} for block "
    "blk_{blk} terminating",
    "{ts} {lvl} dfs.DataNode$DataXceiver: Receiving block blk_{blk} src: "
    "/{ip}:{port} dest: /{ip2}:50010",
    "{ts} {lvl} dfs.FSNamesystem: BLOCK* NameSystem.addStoredBlock: blockMap "
    "updated: {ip}:50010 is added to blk_{blk} size {size}",
    "{ts} {lvl} executor.Executor: Finished task {task}.0 in stage {stage}.0 "
    "(TID {tid}). {small} bytes result sent to driver",
    "{ts} {lvl} storage.BlockManager: Found block rdd_{stage}_{task} locally",
    "{ts} {lvl} [QuorumPeer[myid={d}]/0:0:0:0:0:0:0:0:2181:"
    "FastLeaderElection@{line}] - Notification time out: {ms}",
    "{ts} {lvl} nova.compute.manager [req-{req} - - - - -] [instance: {uuid}] "
    "VM {state} (Lifecycle Event)",
    "{ts} {lvl} nova.osapi_compute.wsgi.server [req-{req}] {ip} \"GET "
    "/v2/{tenant}/servers/detail HTTP/1.1\" status: 200 len: {size} time: "
    "0.{ms}",
    "{ts} {lvl} org.apache.hadoop.mapreduce.v2.app.MRAppMaster: Created "
    "MRAppMaster for application appattempt_{epoch}_{app}_000001",
    "{ts} {lvl} RAS KERNEL {node} instruction cache parity error corrected",
    "{ts} {lvl} RAS APP {node} ciod: failed to read message prefix on control "
    "stream (CioStream socket to {ip}:{port}",
    "{ts} {lvl} org.apache.hadoop.yarn.server.nodemanager.containermanager."
    "container.ContainerImpl: Container container_{epoch}_{app}_01_{cont} "
    "transitioned from {from_} to {to}",
)
STATES = ("Started", "Stopped", "Paused", "Resumed")
PHASES = ("NEW", "LOCALIZING", "LOCALIZED", "RUNNING", "EXITED_WITH_SUCCESS",
          "DONE")


def _zipf(rng, k: int, count: int, exponent: float) -> np.ndarray:
    p = 1.0 / np.arange(1, k + 1) ** exponent
    return rng.choice(k, count, p=p / p.sum())


def generate(n: int, rng: np.random.Generator, layout: np.random.Generator,
             *, mean_gap_ms: float, template_exponent: float,
             field_exponent: float, pool: int,
             start_epoch_s: int) -> np.ndarray:
    order = layout.permutation(len(TEMPLATES))
    blks = layout.integers(-2**62, 2**62, pool)
    ips = [f"10.{a}.{b}.{c}" for a, b, c in
           layout.integers(0, 256, (pool, 3)).tolist()]
    hexes = [bytes(r).hex() for r in layout.integers(0, 256, (pool, 16),
                                                     np.uint8)]
    nodes = [f"R{r:02d}-M{m}-N{k}-C:J{j:02d}-U{u:02d}" for r, m, k, j, u in
             layout.integers(0, 16, (pool, 5)).tolist()]
    epoch = str(start_epoch_s * 1000 + int(rng.integers(0, 1000)))
    stamps = {}
    lines, size, t0 = [], 0, float(start_epoch_s)
    while size < n:
        count = (n - size) // 60 + 64
        z = lambda k: _zipf(rng, k, count, field_exponent)  # noqa: E731
        tmpl = order[_zipf(rng, len(TEMPLATES), count, template_exponent)]
        ts = t0 + np.cumsum(rng.exponential(mean_gap_ms, count)) / 1e3
        t0 = float(ts[-1])
        ip, ip2, req, uuid, tenant = z(pool), z(pool), z(pool), z(pool), z(16)
        cols = (
            _zipf(rng, len(LEVELS), count, field_exponent),
            rng.integers(0, 10, count), blks[z(pool)],
            rng.integers(30000, 61000, count),
            rng.lognormal(16, 2, count).astype(np.int64),
            rng.integers(600, 3000, count),
            (len(lines) + np.arange(count)) // 7,
            (len(lines) + np.arange(count)) // 500,
            len(lines) + np.arange(count) + rng.integers(0, 3, count),
            rng.integers(600, 900, count),
            rng.integers(100, 99999, count),
            rng.integers(0, len(STATES), count),
            (len(lines) + np.arange(count)) // 2000,
            rng.integers(1, 99, count),
            rng.integers(0, len(PHASES) - 1, count),
            z(pool), ts, tmpl, ip, ip2, req, uuid, tenant)
        for (lvl, d, blk, port, nbytes, small, task, stage, tid, at, ms,
             state, app, cont, phase, node, t, k, a, a2, rq, uu,
             tn) in zip(*(c.tolist() for c in cols)):
            sec = int(t)
            if sec not in stamps:
                stamps[sec] = time.strftime("%Y-%m-%d %H:%M:%S",
                                            time.gmtime(sec))
            line = TEMPLATES[k].format(
                ts=f"{stamps[sec]},{int(t * 1000) % 1000:03d}",
                lvl=LEVELS[lvl], d=d, blk=blk, ip=ips[a], ip2=ips[a2],
                port=port, size=nbytes, task=task, stage=stage, tid=tid,
                small=small, line=at, ms=ms, req=hexes[rq], uuid=hexes[uu],
                tenant=hexes[tn], state=STATES[state], epoch=epoch,
                app=f"{app:04d}", cont=f"{cont:06d}", from_=PHASES[phase],
                to=PHASES[phase + 1], node=nodes[node]) + "\n"
            lines.append(line)
            size += len(line)
    return np.frombuffer("".join(lines).encode(), np.uint8)[:n].copy()
