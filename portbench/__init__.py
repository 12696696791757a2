"""The port's benchmark: ``python portbench/run.py --workload <cell> ...``."""
