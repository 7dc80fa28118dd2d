"""The port's serving entry points: the CLI on the CPU, and the refusals
of the server, the swarm and the CLI (no card, weights elsewhere, a dtype
other than float32)."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import archs  # noqa: E402
from repro_torch.core.subcge import SubCGEConfig  # noqa: E402
from repro_torch.launch import serve as tcli  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve import (DecodeServer, ServeConfig,  # noqa: E402
                               ServeSwarmSim)

from _torch_parity import one_thread  # noqa: E402,F401


def test_cli_on_the_cpu(capsys, one_thread):
    assert tcli.main(["--reduced", "--batch", "2", "--requests", "3",
                      "--prompt-len", "6", "--new", "3", "--sampling",
                      "temperature", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "3 requests x 3 new tokens (temperature)" in out[0]
    assert "'emitted': 9" in out[0] and len(out) == 4


def test_server_runs_where_its_weights_are():
    arch = archs.reduced(archs.get("tinyllama-1.1b"))
    params = tf.init_params(arch, 0)
    serve = ServeConfig(max_batch=2, page_size=4, n_pages=8, max_seq=16)
    if torch.cuda.is_available():
        with pytest.raises(ValueError):          # weights on the CPU
            DecodeServer(arch, params, serve)
    else:                                        # no card, no fallback
        with pytest.raises(RuntimeError):
            DecodeServer(arch, params, serve)
        with pytest.raises(RuntimeError):
            ServeSwarmSim(arch, SubCGEConfig(rank=4), serve)
        with pytest.raises(RuntimeError):
            tcli.main(["--reduced"])
    half = {p: t.double() for p, t in params.items()}
    with pytest.raises(ValueError):
        DecodeServer(arch, half, serve, device="cpu")
