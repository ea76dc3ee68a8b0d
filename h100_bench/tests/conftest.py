"""Shared pieces of the benchmark's own tests, which run on the CPU. The
tiny cell under ``tiny/`` runs the whole harness at a size the CPU holds."""

import argparse
import os

import pytest

from h100_bench import harness

TINY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiny")


def tiny_cell(**limits):
    workload = harness.load_json(TINY, "workload.json")
    workload["limits"] = dict(workload["limits"], **limits)
    e2e = harness.load_json(harness.ROOT, "BENCHMARK.json")["end_to_end"]
    return harness.assemble("tiny", workload, 1, harness.load_json(TINY, "config.json"),
                            harness.load_json(TINY, "mix.json"),
                            [dict(m, workloads=["tiny"]) for m in e2e], [])


def tiny_args(seed=2 ** 31 + 7, seconds=0.05):
    return argparse.Namespace(workload="tiny", seed=seed, seconds=seconds, trace=0)


@pytest.fixture(scope="session")
def run_module():
    return harness.load_module(os.path.join(harness.BENCH, "run.py"), "h100_bench_run")
