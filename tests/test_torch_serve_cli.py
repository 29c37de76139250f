"""The port's serving CLI (``python -m repro_torch.launch.serve``) against
the reference's ``repro.launch.serve.main`` on the same flags: the same
confirmed-track count every frame, for both of its filters."""
import pytest

from repro.launch import serve as jserve
from repro_torch.launch import serve


@pytest.mark.parametrize("kind", ["lkf", "ekf"])
def test_serve_cli_matches_reference(kind, capsys):
    argv = ["--filter", kind, "--frames", "20", "--capacity", "32"]
    want = jserve.main(argv)
    got = serve.main(argv + ["--device", "cpu"])
    assert got == want
    assert len(got) == 20 and max(got) > 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1].startswith(f"[serve] {kind} frames=20 ")
    assert out[-1].split("confirmed")[1] == out[-2].split("confirmed")[1]


def test_serve_cli_takes_only_the_reference_filters():
    with pytest.raises(SystemExit):
        serve.main(["--filter", "imm", "--device", "cpu"])
