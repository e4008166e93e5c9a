"""``chip_smoke.py`` on the CPU: its phase helper and its refusal to run
without a card. The script imports nothing but the standard library at its
top, so it imports here."""
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_phase_returns_the_phase_result(smoke, capsys):
    assert smoke.phase("adds", lambda a, b=0: a + b, 2, b=3) == 5
    assert capsys.readouterr().out == ""  # nothing on stdout, the log goes to stderr


def test_failed_phase_prints_where_and_reraises(smoke, capsys):
    def broken(n):
        raise AssertionError("x" * n)

    with pytest.raises(AssertionError):
        smoke.phase("serve olmo-1b", broken, 400)
    out, err = capsys.readouterr()
    line = json.loads(out.strip())
    assert line == {"failed_phase": "serve olmo-1b", "error": "AssertionError: " + "x" * 300}
    assert "Traceback" in err and "broken" in err


def test_main_refuses_without_a_card(smoke, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert smoke.main() != 0
    assert capsys.readouterr().out == ""
