"""Tools of the port (``python3 -m adacom_tpu_torch.tools.<name>``): the
measurement tools (ClickBench and TPC-H runners, the decode-scan
roofline, the [succinct] recorder, the grouped, string, adaptive and
streamed-join benches, the routing sweep), the two differential fuzzers
and the TPC-H verifier. None writes a file unless it is given a path."""

import os


def device_name(platform: str) -> str:
    """What a tool ran on: the card's name and power limit as nvidia-smi
    gives them (`bench.headline.device_info`), or the host's CPU count."""
    from adacom_tpu_torch.bench.headline import device_info

    info = device_info(platform)
    if info == "cpu":
        return f"the host's {os.cpu_count()} CPUs"
    return f"{info['name']}, {info['power_limit']}"


def launch_counts() -> dict:
    """The device tiers' counters: B1/B2/B3 kernel launches, the decode
    kernel's and the grouped-accumulate kernel's (`scatter`; a CPU run
    takes their plain versions, which count nothing), and the generic
    device path's runs."""
    from adacom_tpu_torch.exec import device_scan
    from adacom_tpu_torch.ops import agg, fused_scan, grouped_scan, segcodec

    return {"B1": fused_scan.KERNEL_LAUNCHES,
            "B2": grouped_scan.GROUPED_LAUNCHES,
            "B3": grouped_scan.MULTI_LAUNCHES,
            "decode": segcodec.DECODE_LAUNCHES,
            "scatter": agg.SCATTER_LAUNCHES,
            "device_scan": device_scan.RUNS}


def launches_since(before: dict) -> dict:
    """The increments of `launch_counts()` since the reading `before`."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in now}
