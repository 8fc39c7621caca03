"""The device, the card's label and the timing that the port's scripts share.

- device_of(platform, script): the CPU for platform "cpu", else the card;
  without a card the script exits non-zero with a message (it never falls
  back to the CPU);
- card_label(device): torch's device name and nvidia-smi's name and power
  limit (`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`),
  to print beside every time; "cpu" on the CPU;
- time_calls(fn, reps, device): milliseconds of one call of fn, the host's
  and the card's.  One untimed call, then `reps` calls between two
  synchronizations (host wall time), then, on the card, `reps` more queued
  behind a sleep kernel between two CUDA events (the card's elapsed time:
  the kernels back to back only where the host issues the whole batch
  within the sleep, about 20 ms, and no call reads a value on the host;
  otherwise the host's pace shows in it, so a card time close to the host
  time says the calls are host-bound).  On the CPU the card's time is None
  (not measured).
"""

import subprocess
import sys
import time

# clock cycles of the sleep kernel that holds the stream while a timed batch
# is queued (about 20 ms on an H100)
SLEEP_CYCLES = 40_000_000


def device_of(platform, script):
    import torch

    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        sys.exit(f"{script}: no CUDA device; pass --platform cpu to run on the CPU")
    return torch.device("cuda")


def card_label(device=None):
    """torch's device name and nvidia-smi's name and power limit; "cpu" for a
    CPU device."""
    import torch

    if device is not None and torch.device(device).type == "cpu":
        return "cpu"
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True)
    return f"{torch.cuda.get_device_name(0)}; nvidia-smi: {proc.stdout.strip().splitlines()[0]}"


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_calls(fn, reps, device):
    """{"host_ms": ..., "card_ms": ...} of one call of fn (see the module's
    docstring); card_ms is None on the CPU."""
    import torch

    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(device)
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    if device.type != "cuda":
        return {"host_ms": host_ms, "card_ms": None}
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize(device)
    return {"host_ms": host_ms, "card_ms": start.elapsed_time(stop) / reps}


def ms_text(t):
    """'h ms host, c ms card' of a time_calls record."""
    card = "not measured" if t["card_ms"] is None else f"{t['card_ms']:.3f} ms"
    return f"host {t['host_ms']:.3f} ms, card {card}"
