#!/usr/bin/env python3
"""Run a command and sample, beside it, where the host's cores and the
card's time go: which of the command's processes burn CPU, and how busy the
card is.

    python3 tools/torch_run_sampler.py --out OUT.jsonl [--every 2] \
        -- python3 chip_smoke.py

Every ``--every`` seconds it writes one JSON line to ``--out``:

  * ``t``: seconds since the command started;
  * ``load1``: the host's one-minute load average (``/proc/loadavg``);
  * ``procs``: ``[pid, ppid, cpu_s, nice, threads, command]`` for the
    command and every process below it, ``cpu_s`` its user plus system
    seconds so far (``/proc/PID/stat``), so the CPU a process took between
    two samples is the difference of its ``cpu_s``;
  * ``gpu``: the card's ``utilization.gpu`` (the share of the last sample
    period in which a kernel ran, in percent), ``memory.used`` (MiB) and
    ``power.draw`` (W), from ``nvidia-smi`` when it is there, else null.

It imports nothing of torch, so it adds one light process. The command's
exit code is this script's.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

CLK_TCK = os.sysconf("SC_CLK_TCK")


def _stat(pid: int):
    """(ppid, cpu seconds, nice, threads) of ``pid``, or None if it ended."""
    try:
        with open(f"/proc/{pid}/stat") as fh:
            raw = fh.read()
    except OSError:
        return None
    # the command name is in parentheses and may hold spaces
    fields = raw[raw.rindex(")") + 2:].split()
    return (int(fields[1]), (int(fields[11]) + int(fields[12])) / CLK_TCK,
            int(fields[16]), int(fields[17]))


def _cmdline(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as fh:
            return fh.read().replace(b"\0", b" ").decode(errors="replace")[
                :160].strip()
    except OSError:
        return ""


def descendants(root: int):
    """[pid, ppid, cpu_s, nice, threads, command] of ``root`` and every
    process below it."""
    stats = {}
    for name in os.listdir("/proc"):
        if name.isdigit():
            st = _stat(int(name))
            if st is not None:
                stats[int(name)] = st
    children = {}
    for pid, st in stats.items():
        children.setdefault(st[0], []).append(pid)
    out, todo = [], [root]
    while todo:
        pid = todo.pop()
        if pid in stats:
            ppid, cpu, nice, threads = stats[pid]
            out.append([pid, ppid, round(cpu, 2), nice, threads,
                        _cmdline(pid)])
        todo.extend(children.get(pid, ()))
    return out


def gpu_sample():
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=utilization.gpu,memory.used,"
             "power.draw", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return None
    if not line:
        return None
    util, mem, power = (x.strip() for x in line.splitlines()[0].split(","))
    return {"util": float(util), "mem_mib": float(mem),
            "power_w": float(power)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--every", type=float, default=2.0)
    p.add_argument("command", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    command = args.command[1:] if args.command[:1] == ["--"] else args.command
    if not command:
        p.error("no command given")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    t0 = time.perf_counter()
    child = subprocess.Popen(command)
    with open(args.out, "w") as out:
        while child.poll() is None:
            with open("/proc/loadavg") as fh:
                load1 = float(fh.read().split()[0])
            out.write(json.dumps({
                "t": round(time.perf_counter() - t0, 2), "load1": load1,
                "procs": descendants(child.pid), "gpu": gpu_sample()}) + "\n")
            out.flush()
            try:
                child.wait(timeout=args.every)
            except subprocess.TimeoutExpired:
                pass
    return child.returncode


if __name__ == "__main__":
    sys.exit(main())
