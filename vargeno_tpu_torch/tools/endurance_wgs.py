"""Genome-scale endurance run with a mid-stream SIGKILL and a resume (port
of ``tools/endurance_wgs.py``).

Drives ``vargeno_tpu_torch.tools.rehearse_wgs --phase geno`` through THREE
legs, each a fresh interpreter, over the same ``reads_{N}.fq`` stream:

  A. uninterrupted            -> out_full.vcf      (ground truth)
  B. checkpointed, SIGKILLed  -> checkpoint on disk (-9: no cleanup, the
     crash case)
  C. the same command again   -> resumes from the checkpoint ->
     out_resumed.vcf

and requires out_resumed.vcf to be BYTE-IDENTICAL to out_full.vcf (counts
are order-independent sums; the checkpoint holds the merged counts and the
read offset, so a resumed run reproduces the uninterrupted output).

Leg B is killed on the checkpoint's own read offset, not on a progress
line: once the offset in ``<checkpoint>.json`` reaches ``--kill-after-frac``
of the stream (and before the stream's end), so a stream that takes seconds
on the card is cut as surely as one that takes minutes. The run fails if
leg B ends before that point or dies before any checkpoint.

    python -m vargeno_tpu_torch.tools.endurance_wgs [--reads 2097152]
        [--cache DIR] [--mb 3000 --snps 5000000 --base-reads 65536]
        [--kill-after-frac 0.5] [--device cuda] [--devices DEV,...]
        [--batch 2048] [--checkpoint-every 16]

Expects the index already built (``rehearse_wgs --phase index`` with the
same ``--cache``, ``--mb``, ``--snps`` and ``--base-reads`` as its
``--reads``). The last line is one JSON object ``{"endurance": ...}``.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time

from .rehearse_wgs import default_cache


def leg_command(args, extra) -> list:
    cmd = [sys.executable, "-m", "vargeno_tpu_torch.tools.rehearse_wgs",
           "--phase", "geno", "--cache", args.cache, "--mb", str(args.mb),
           "--snps", str(args.snps), "--reads", str(args.base_reads),
           "--device", args.device, "--batch", str(args.batch),
           "--extra-reads", str(args.reads), "--limit-batches", "0",
           "--checkpoint-every", str(args.checkpoint_every),
           "--progress-every", str(args.progress_every), *extra]
    if args.devices:
        cmd += ["--devices", args.devices]
    return cmd


def checkpoint_offset(ck: str):
    """The read offset of the checkpoint ``ck`` (None before the first)."""
    try:
        with open(ck + ".json") as f:
            return int(json.load(f)["n_reads"])
    except (OSError, ValueError, KeyError):
        return None


def run_leg(cmd, tag, kill=None, poll_s=0.01) -> dict:
    """Run one leg, relaying its output. ``kill = (ck, kill_at, total)``
    SIGKILLs it once the checkpoint's offset is at least ``kill_at`` and
    below ``total``. Returns the exit code, whether it was killed, the
    offset seen at the kill, the wall seconds and the leg's ``{"geno"}``
    line (None if it printed none)."""
    print(f"[endurance] leg {tag}: {' '.join(cmd)}", flush=True)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    t0 = time.perf_counter()
    p = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    found: dict = {}

    def relay():
        for line in p.stdout:
            print(f"[{tag}] {line}", end="", flush=True)
            if line.startswith('{"geno"'):
                found["geno"] = json.loads(line)["geno"]

    reader = threading.Thread(target=relay, daemon=True)
    reader.start()
    killed_at = None
    try:
        while p.poll() is None:
            if kill is not None and killed_at is None:
                ck, kill_at, total = kill
                off = checkpoint_offset(ck)
                if off is not None and kill_at <= off < total:
                    os.kill(p.pid, signal.SIGKILL)
                    killed_at = off
                    print(f"[endurance] SIGKILL at checkpoint offset {off} "
                          f"reads", flush=True)
            time.sleep(poll_s)
    finally:
        if p.poll() is None:
            p.kill()
        p.wait()
        reader.join(10)
    return dict(rc=p.returncode, killed=killed_at is not None
                and p.returncode == -signal.SIGKILL,
                killed_at=killed_at, seconds=time.perf_counter() - t0,
                geno=found.get("geno"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vargeno_tpu_torch.tools.endurance_wgs",
        description="kill/resume endurance over a genome-scale stream")
    ap.add_argument("--reads", type=int, default=2_097_152)
    ap.add_argument("--cache", default=None,
                    help="the rehearsal's cache directory (rehearse_wgs's "
                         "default when not given)")
    ap.add_argument("--mb", type=int, default=3000)
    ap.add_argument("--snps", type=int, default=5_000_000)
    ap.add_argument("--base-reads", type=int, default=65_536,
                    help="the --reads the index's inputs were made with")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--devices", default=None)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--checkpoint-every", type=int, default=16)
    ap.add_argument("--kill-after-frac", type=float, default=0.5)
    ap.add_argument("--progress-every", type=float, default=20.0)
    args = ap.parse_args(argv)
    args.cache = args.cache or default_cache()

    t0 = time.perf_counter()
    ck = os.path.join(args.cache, "endurance_ck")
    for suf in (".npz", ".json"):
        try:
            os.remove(ck + suf)
        except OSError:
            pass
    legs = {}

    def fail(msg) -> int:
        print(f"[endurance] FAIL: {msg}", flush=True)
        print(json.dumps({"endurance": dict(ok=False, error=msg,
                                            legs=legs)}), flush=True)
        return 1

    # Leg A: uninterrupted ground truth
    legs["A"] = run_leg(leg_command(args, ["--out", "out_full.vcf"]), "A")
    if legs["A"]["rc"] != 0:
        return fail(f"leg A failed rc={legs['A']['rc']}")

    # Leg B: checkpointed, SIGKILLed past the kill point
    kill_at = int(args.reads * args.kill_after_frac)
    resume = ["--out", "out_resumed.vcf", "--checkpoint", ck]
    legs["B"] = run_leg(leg_command(args, resume), "B",
                        kill=(ck, kill_at, args.reads))
    if not legs["B"]["killed"]:
        return fail(f"leg B ended (rc={legs['B']['rc']}) before the kill "
                    f"point {kill_at}; lower --kill-after-frac or "
                    f"--checkpoint-every")
    offset = checkpoint_offset(ck)
    if offset is None or not kill_at <= offset < args.reads:
        return fail(f"after the kill the checkpoint holds offset {offset}, "
                    f"not in [{kill_at}, {args.reads})")

    # Leg C: the same command, resumed to completion
    legs["C"] = run_leg(leg_command(args, resume), "C")
    if legs["C"]["rc"] != 0:
        return fail(f"leg C (resume) failed rc={legs['C']['rc']}")
    geno_c = legs["C"]["geno"] or {}
    if geno_c.get("resumed_from") != offset:
        return fail(f"leg C resumed from {geno_c.get('resumed_from')}, not "
                    f"the checkpoint's {offset}")

    with open(os.path.join(args.cache, "out_full.vcf"), "rb") as f:
        full = f.read()
    with open(os.path.join(args.cache, "out_resumed.vcf"), "rb") as f:
        res = f.read()
    if full != res:
        return fail("PARITY FAIL: resumed output differs from uninterrupted")
    total_s = time.perf_counter() - t0
    print(f"[endurance] PARITY PASS: kill+resume output byte-identical "
          f"({len(full)} bytes, {args.reads} reads, killed at checkpoint "
          f"offset {offset}, {total_s:.0f}s total)", flush=True)
    print(json.dumps({"endurance": dict(
        ok=True, reads=args.reads, kill_at=kill_at, killed_at_offset=offset,
        vcf_bytes=len(full), seconds=total_s, legs=legs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
