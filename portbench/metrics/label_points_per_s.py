"""label_points_per_s: points sampled and labelled in the window's whole
passes over its host seconds (the window ends in a synchronize)."""


def read(r):
    return r.window["points"] / r.window["seconds"]
