"""The benchmark of tpulbm_torch: BENCHMARK.json's cells run as whole
Runner.run() jobs (run.py), checked against a plain reference
(reference/lbm.py, check.py) and measured on the host clock and the
device trace (harness.py, yardstick.py, metrics/)."""
