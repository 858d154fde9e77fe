"""The port's closed-loop serving benchmark (``repro_torch.bench.
serving_qps``) at the reference's smoke size on the CPU: both scenarios
run, answer queries, apply writes in the mixed one, and the record lands
as ``hw_cpu_serving_qps.json``."""

import json

from repro_torch import obs
from repro_torch.bench import serving_qps


def test_serving_qps_smoke(tmp_path):
    bench = serving_qps.run("smoke", device="cpu", out_dir=str(tmp_path))
    rows = {r["scenario"]: r for r in bench.rows}
    assert set(rows) == {"read_only", "mixed"}
    for r in rows.values():
        assert (r["n_rows"], r["dim"], r["clients"]) == (192, 48, 2)
        assert r["queries"] > 0 and r["qps"] > 0
        assert 0 < r["p50_ms"] <= r["p99_ms"]
        assert r["mean_coalesced"] >= 1.0
    assert rows["read_only"]["inserted"] == rows["read_only"]["deleted"] == 0
    assert rows["mixed"]["inserted"] > 0
    assert rows["mixed"]["view_swaps"] > 0
    record = json.loads((tmp_path / "hw_cpu_serving_qps.json").read_text())
    assert record["device"] == "cpu" and record["size"] == "smoke"
    assert record["qps"] == rows["mixed"]["qps"]
    assert not obs.enabled()
