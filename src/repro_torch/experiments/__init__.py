"""The reference's `experiments/` scripts on the port's dry run.

* perf_probe.py  — one (arch × shape) pair traced on a fake process
                   group, with configuration overrides: memory a device,
                   the roofline terms and the top collective and memory
                   contributors
* make_report.py — the dry run's JSON as the markdown roofline tables

Each runs as ``python -m repro_torch.experiments.<name>``; neither runs
anything on a device.
"""
