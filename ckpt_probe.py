"""What an async checkpoint write costs the step loop beside it, on one
CUDA card (the port only; nothing of JAX).

    python3 ckpt_probe.py stall   # phase 7b's transformer Session: three
                                  # async saves, each followed by windows
                                  # of 4 and a timed barrier snapshot
                                  # after each window while the writer works
    python3 ckpt_probe.py d2h     # ways of copying a 2.4 GB snapshot to
                                  # the host from another thread while the
                                  # main thread launches and syncs

``stall`` prints, a save, the writer's phases (copy to the host,
serialize and commit; each pinned allocation and its seconds) from the
save's start, the slowest windows and snapshots with their times, and
the host caching allocator's statistics. ``d2h`` prints, a way and a
repetition, the copy's seconds and the main loop's p50 and slowest
iteration (a one-element launch, a sync and some Python).
"""

import os
import statistics
import sys
import tempfile
import threading
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))


def stall():
    import chip_smoke as cs
    import simple_tensorflow_tpu_torch as stf
    from simple_tensorflow_tpu_torch import checkpoint as pckpt
    from simple_tensorflow_tpu_torch.checkpoint import snapshot as snap
    from simple_tensorflow_tpu_torch.models import transformer as tr

    print(cs.card_line(), flush=True)
    marks = []
    orig_mat = snap.TrainingStateSnapshot.materialize

    def mat(self):
        marks.append(("d2h+", time.perf_counter()))
        r = orig_mat(self)
        marks.append(("d2h-", time.perf_counter()))
        return r

    orig_w = snap.write_native_checkpoint

    def wr(*a, **k):
        marks.append(("ser+", time.perf_counter()))
        r = orig_w(*a, **k)
        marks.append(("ser-", time.perf_counter()))
        return r

    orig_empty = torch.empty

    def empty(*a, **k):
        if k.get("pin_memory"):
            t = time.perf_counter()
            r = orig_empty(*a, **k)
            marks.append(("pin", t, time.perf_counter() - t))
            return r
        return orig_empty(*a, **k)

    snap.TrainingStateSnapshot.materialize = mat
    snap.write_native_checkpoint = wr
    torch.empty = empty
    cfg = tr.TransformerConfig.big()
    batch = cs.tf_batch(cs.TF_B, cs.TF_SRC, cs.TF_TGT, cfg.vocab_size,
                        pads=False)
    g, m, _, init, sv = cs.loop_build(stf, tr, cfg, saver=True)
    with g.as_default():
        asyn = stf.train.Saver(backend="async", max_to_keep=1)
    sess = stf.Session(graph=g)
    sess.run(init)
    fetch = [m["train_op"], m["loss"]]
    feeds = cs.tf_feeds(m, batch)
    for _ in range(3):
        sess.run_steps(fetch, 4, feed_dict=feeds)
    root = tempfile.mkdtemp()
    vars_map = sv._vars(g)

    def snap_ms():
        torch.cuda.synchronize()
        t = time.perf_counter()
        s = snap.capture_training_state(sess, vars_map)
        dt = time.perf_counter() - t
        s.release_device_state()
        return dt * 1e3

    print("idle snapshot ms", [round(snap_ms(), 3) for _ in range(3)],
          flush=True)
    for rnd in range(3):
        marks.clear()
        t_save = time.perf_counter()
        asyn.save(sess, os.path.join(root, "m"), global_step=rnd,
                  write_meta_graph=False)
        st = dict(asyn.last_save_stats)
        wins, snaps = [], []
        while not pckpt.get_writer()._idle.is_set():
            t = time.perf_counter()
            sess.run_steps(fetch, 4, feed_dict=feeds)
            wins.append((t - t_save, (time.perf_counter() - t) * 1e3))
            snaps.append((time.perf_counter() - t_save, snap_ms()))
        asyn.wait_until_finished()
        print(f"round {rnd}: save stall {st['stall'] * 1e3:.3f} ms "
              f"(snapshot {st['snapshot'] * 1e3:.3f})", flush=True)
        print("  writer:", [(k[0], round(k[1] - t_save, 3))
                            + tuple(round(x, 3) for x in k[2:])
                            for k in marks], flush=True)
        for what, rows in (("windows", wins), ("snapshots", snaps)):
            slow = sorted(((round(t, 2), round(v, 1)) for t, v in rows),
                          key=lambda x: -x[1])[:6]
            print(f"  {what} ms (t, ms) slowest: {slow} median "
                  f"{round(statistics.median(v for _, v in rows), 2)} n "
                  f"{len(rows)}", flush=True)
        if hasattr(torch.cuda, "host_memory_stats"):
            hs = torch.cuda.host_memory_stats()
            print("  host mem stats", {k: v for k, v in hs.items()
                                       if "alloc" in k}, flush=True)
    pckpt.shutdown_writer()


def d2h():
    from simple_tensorflow_tpu_torch.checkpoint import snapshot as snap

    dev = torch.device("cuda")
    # a bf16 flat group, two f32 slots of its length and 40 small tensors
    sizes = [176295936, 176295936, 176295936] + [4_000_000] * 40
    bases = [torch.randn(sizes[0], device=dev).to(torch.bfloat16)] + \
        [torch.randn(n, device=dev) for n in sizes[1:]]
    nbytes = sum(b.numel() * b.element_size() for b in bases)
    print("bytes", nbytes, flush=True)
    x = torch.zeros(1, device=dev)

    def main_loop(stop, gaps):
        last = time.perf_counter()
        while not stop.is_set():
            x.add_(1)
            torch.cuda.synchronize()
            {i: i * 2 for i in range(2000)}  # some Python work
            now = time.perf_counter()
            gaps.append(now - last)
            last = now

    def run(name, fn, reps=2):
        for r in range(reps):
            stop, gaps = threading.Event(), []
            th = threading.Thread(target=main_loop, args=(stop, gaps))
            th.start()
            time.sleep(0.3)
            t = time.perf_counter()
            out = fn()
            dt = time.perf_counter() - t
            time.sleep(0.1)
            stop.set()
            th.join()
            ok = all(torch.equal(
                o.view(torch.uint8).reshape(-1)[:64],
                b.cpu().view(torch.uint8).reshape(-1)[:64])
                for o, b in zip(out, bases))
            g = sorted(gaps)
            print(f"{name} rep {r}: d2h {dt:.3f} s, main loop p50 "
                  f"{statistics.median(g) * 1e3:.3f} ms max "
                  f"{g[-1] * 1e3:.1f} ms, >50ms "
                  f"{sum(1 for v in g if v > 0.05)}, ok {ok}", flush=True)
            del out

    def pinned_each():
        s, outs = torch.cuda.Stream(), []
        with torch.cuda.stream(s):
            for b in bases:
                h = torch.empty(b.shape, dtype=b.dtype, pin_memory=True)
                h.copy_(b, non_blocking=True)
                outs.append(h)
        s.synchronize()
        return outs

    def bounce(chunk):
        def fn():
            old, snap.D2H_CHUNK = snap.D2H_CHUNK, chunk
            try:
                c = snap.DeviceCopies()
                c.bases.extend(bases)
                c.ready = torch.cuda.Event()
                c.ready.record()
                h = snap._copy_to_host(c)
                return [h[id(b)] for b in bases]
            finally:
                snap.D2H_CHUNK = old
        return fn

    persist = {}

    def persistent_pinned():
        if "p" not in persist:
            persist["p"] = torch.empty(nbytes, dtype=torch.uint8,
                                       pin_memory=True)
        buf, s, outs, off = persist["p"], torch.cuda.Stream(), [], 0
        with torch.cuda.stream(s):
            for b in bases:
                n = b.numel() * b.element_size()
                buf[off:off + n].copy_(b.view(-1).view(torch.uint8),
                                       non_blocking=True)
                outs.append(buf[off:off + n])
                off += n
        s.synchronize()
        return outs

    def pageable_direct():
        outs = []
        for b in bases:
            h = torch.empty(b.shape, dtype=b.dtype)
            h.copy_(b)
            outs.append(h)
        return outs

    run("bounce 64MB", bounce(64 << 20))
    run("bounce 256MB", bounce(256 << 20))
    run("pageable direct", pageable_direct)
    run("persistent pinned", persistent_pinned)
    run("pinned each", pinned_each)


def main():
    if sys.argv[1:] not in (["stall"], ["d2h"]):
        sys.exit(f"usage: {sys.argv[0]} stall|d2h")
    if not torch.cuda.is_available():
        sys.exit("ckpt_probe: no CUDA card")
    sys.path.insert(0, ROOT)
    {"stall": stall, "d2h": d2h}[sys.argv[1]]()


if __name__ == "__main__":
    main()
