"""The port stands alone: every repro_torch module imports without JAX and
without the reference package, and its entry points default to the card."""
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def test_every_module_imports_without_jax_or_repro():
    script = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len(mods), bad)\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    n, bad = out.stdout.strip().split(" ", 1)
    assert bad == "[]", bad
    assert int(n) >= 25


def test_module_list_covers_the_slice():
    import repro_torch
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                    "repro_torch.")}
    for want in ("net.bytesops", "net.eth", "net.ipv4", "net.udp", "net.rpc",
                 "net.tiles", "net.stack", "net.frames", "core.compiler",
                 "core.routing", "core.telemetry", "core.scaleout",
                 "core.topology", "core.noc", "core.deadlock",
                 "transport.rate", "obs.reasons", "kernels.checksum.ops",
                 "kernels.checksum.ref", "kernels.rs_encode.ops",
                 "kernels.rs_encode.ref", "kernels.rs_encode.gf",
                 "apps.echo", "apps.reed_solomon", "convert", "_build"):
        assert f"repro_torch.{want}" in names, want


def test_entry_point_defaults_to_cuda():
    from repro_torch.net.stack import UdpStack, resolve_device
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        UdpStack([], 0x0A000001)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    # the compiled pipeline's own entry point defaults to the card too
    pipe = UdpStack([], 0x0A000001, device="cpu").pipeline
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipe.init_state()
    assert pipe.init_state(device="cpu")["telemetry"]["step"].device.type \
        == "cpu"
