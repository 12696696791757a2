"""label.cull_kept_share: the (block, chunk) pairs the culled method's
distance cull kept, as a share of those it considered, summed over the
process's culled calls (the port's counter ``sdf_culled.CULL_PAIRS``), in
%: set-up's pass as well as the window's, since nothing resets the counter
between them. None where the program keeps no such counter or made no
culled call."""

import sys


def read(r):
    culled = sys.modules.get("sdf_representation_tpu_torch.ops.sdf_culled")
    pairs = getattr(culled, "CULL_PAIRS", None)
    if not pairs or not pairs.get("considered"):
        return None
    return 100.0 * pairs["kept"] / pairs["considered"]
