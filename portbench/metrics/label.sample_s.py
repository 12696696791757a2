"""label.sample_s: seconds a pass spends drawing its points on the host, the
sampler's own stage clock (``sampler.LAST_STAGE_SECONDS["sample"]``), the
mean over the window's passes."""


def read(r):
    values = [s["sample"] for s in r.work.get("stage_seconds", []) if "sample" in s]
    return sum(values) / len(values) if values else None
