"""label.idle_unnamed_share: the card-idle time inside the benchmark's
``label_pass`` spans that lies under none of the port's innermost spans of
host work, as a share of the card-idle time inside them, in %. Those spans
are the points drawn (``sampler.draw``), the frames stacked
(``sampler.frame``), the mesh prepared (``sdf.prepare_mesh``), the uploads
(``sdf.upload``), the labels back (``sdf.gather``) and the streams' packing
(``sdf.streams.schedule``). The spans that hold them (``sampler.label``,
``sdf.dense``, ``sdf.culled`` and the culled stages ``sdf.culled.*``) cover
whole calls, so they name no idle here. Low means those spans explain where
the labelling idles. None where the program opens none of them."""

from portbench.harness import spans

LEAVES = ("sampler.draw", "sampler.frame", "sdf.prepare_mesh", "sdf.upload", "sdf.gather",
          "sdf.streams.schedule")


def read(r):
    window = r.device_span()
    if window is None:
        return None
    lo, hi = window
    passes = spans.named(r.trace, lambda n: n == "label_pass", lo, hi)
    leaves = spans.named(r.trace, lambda n: n in LEAVES, lo, hi)
    if not passes or not leaves:
        return None
    idle = spans.idle(r.trace, passes, lo, hi)
    unnamed = spans.idle(r.trace, spans.subtract(passes, leaves), lo, hi)
    return 100.0 * unnamed / idle if idle else None
