"""The port's examples (``examples_torch/``) on the CPU, the twin of
``tests/test_examples.py``: each example's main path imports and runs end
to end through the ``repro_torch.api`` front door with ``--device cpu``
and the reference test's tiny arguments, and prints the reference's
markers.  Also: the quickstart's energy line is the reference
quickstart's, character for character (the energy model is
deterministic); ``serve_batch --mesh`` serves on a 1-rank CPU mesh;
without ``--device`` an example asks for the CUDA device."""
import pytest

torch = pytest.importorskip("torch")


def _energy_line(out: str) -> str:
    return next(line for line in out.splitlines() if line.startswith("[3]"))


def test_quickstart_main(capsys):
    from examples_torch import quickstart

    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "[1]" in out and "analog_fast" in out and "[3]" in out


def test_quickstart_energy_line_is_the_reference(capsys):
    pytest.importorskip("jax")
    from examples import quickstart as ref
    from examples_torch import quickstart

    ref.main([])
    want = _energy_line(capsys.readouterr().out)
    quickstart.main(["--device", "cpu"])
    assert _energy_line(capsys.readouterr().out) == want


@pytest.mark.parametrize("mode", ["digital", "analog_faithful"])
def test_serve_batch_main(capsys, mode):
    from examples_torch import serve_batch

    serve_batch.main(["--requests", "2", "--max-new", "2", "--batch", "2",
                      "--mode", mode, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 2 requests" in out and "tok/s on cpu" in out
    assert "serve.all/serve.batch/serve.decode" in out


def test_serve_batch_mesh_raises(capsys):
    """``--mesh`` serves under a 1-rank (data, model) CPU mesh (a gloo
    group of one, ended after) and prints the reference's markers."""
    from examples_torch import serve_batch

    serve_batch.main(["--mesh", "--requests", "2", "--max-new", "2",
                      "--batch", "2", "--mode", "analog_faithful",
                      "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 2 requests" in out and "tok/s on cpu" in out
    assert "serve.all/serve.batch/serve.decode" in out
    assert not torch.distributed.is_initialized()


def test_lm_analog_train_main(capsys):
    from examples_torch import lm_analog_train

    lm_analog_train.main(["--arch", "stablelm-3b", "--steps", "2",
                          "--batch", "2", "--seq-len", "16",
                          "--device", "cpu"])
    out = capsys.readouterr().out
    assert "analog:" in out and "digital:" in out


def test_ecg_train_main(capsys):
    from examples_torch import ecg_train

    ecg_train.main(["--epochs", "1", "--n-train", "128", "--n-test", "48",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert "analog HIL: detection" in out
    assert "per inference:" in out


def test_examples_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    from examples_torch import quickstart

    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.main([])
