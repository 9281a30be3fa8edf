"""Where the time of a window slide goes, on the card:

    PYTHONPATH=src python3 -m repro_torch.launch.stream_profile

Slides the streams ``chip_smoke.py`` drives (T10I4D100K in a 16 x 8,192
window, chess in 8 x 512; ``data.transaction_stream`` at seed 0) through a
``fused`` ``StreamingMiner``, fills the window untraced, then traces each
evicting slide's ``push`` and ``mine_window`` with ``torch.profiler``, each
in its own window, and prints per stream and phase: the host wall time
(ending in ``torch.cuda.synchronize()``), the device busy time (kernels and
copies; one stream, so they do not overlap), the device's idle share, and
the entries that take the most device time.  Beside them, the host time of
``core.bitmap.pack_transactions`` on the same batches (the push's block
packing).  The last line is one JSON object with the same numbers.  Needs
a card; with none it exits non-zero.
"""
from __future__ import annotations

import json
import sys
import time

import torch

# the streams of the port's streaming cells, which chip_smoke.py also
# drives: (name, n_blocks, block_txns, min_sup, batches, drift_every).
# T10I4D100K's 16 x 8,192-transaction window holds more than the paper's
# whole database, and its last two batches drift; chess is the dense,
# deep-level stream
STREAMS = [("T10I4D100K", 16, 8192, 0.01, 20, 18),
           ("chess", 8, 512, 0.7, 12, 10)]
TOP = 8


def _device_times(prof) -> dict:
    """Device time in ms per kernel or copy name in a trace."""
    out = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            ms = evt.self_device_time_total / 1e3
            if ms > 0:
                ms0, n0 = out.get(evt.key, (0.0, 0))
                out[evt.key] = (ms0 + ms, n0 + evt.count)
    return out


def _traced(fn):
    """``fn()`` under the profiler: (its result, wall ms, device times)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return out, wall_ms, _device_times(prof)


def profile_stream(name, n_blocks, block_txns, min_sup, n_batches, drift) -> dict:
    from ..core.bitmap import pack_transactions
    from ..data import stream_spec, transaction_stream
    from ..streaming import StreamConfig, StreamingMiner
    n_items = stream_spec(name).n_items
    batches = list(transaction_stream(name, block_txns, n_batches, seed=0,
                                      drift_every=drift))
    miner = StreamingMiner(n_items, StreamConfig(min_sup=min_sup, n_blocks=n_blocks,
                                                 block_txns=block_txns))
    for batch in batches[:n_blocks]:
        miner.advance(batch)
    phases = {"push": [0.0, {}], "mine": [0.0, {}]}
    pack_ms = []
    for batch in batches[n_blocks:]:
        t0 = time.perf_counter()
        pack_transactions(batch, n_items)
        pack_ms.append((time.perf_counter() - t0) * 1e3)
        for phase, fn in (("push", lambda: miner.push(batch)),
                          ("mine", miner.mine_window)):
            _, wall, times = _traced(fn)
            phases[phase][0] += wall
            for k, (ms, n) in times.items():
                ms0, n0 = phases[phase][1].get(k, (0.0, 0))
                phases[phase][1][k] = (ms0 + ms, n0 + n)
    n = len(batches) - n_blocks
    out = {"stream": f"{name} {n_blocks}x{block_txns} min_sup={min_sup}",
           "evicting_slides": n,
           "pack_transactions_ms": sum(pack_ms) / n}
    for phase, (wall, times) in phases.items():
        busy = sum(ms for ms, _ in times.values())
        ranked = sorted(times.items(), key=lambda kv: -kv[1][0])[:TOP]
        out[phase] = {"wall_ms": wall / n, "device_busy_ms": busy / n,
                      "idle_share": 1 - busy / wall,
                      "top": [[k, ms / n, c / n] for k, (ms, c) in ranked]}
        print(f"{out['stream']} {phase} (mean of {n} evicting slides, traced): "
              f"wall_ms={wall / n:.3f} device_busy_ms={busy / n:.4f} "
              f"idle_share={1 - busy / wall:.4f}")
        for k, (ms, c) in ranked:
            print(f"  {ms / n:10.4f} ms  {c / n:6.1f} calls  {k[:100]}")
    print(f"{out['stream']} pack_transactions of one batch (host, untraced): "
          f"{out['pack_transactions_ms']:.3f} ms")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("stream_profile: no CUDA device is available", file=sys.stderr)
        return 2
    res = {"device": torch.cuda.get_device_name(0),
           "streams": [profile_stream(*s) for s in STREAMS]}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
