"""train_points_per_s: training points stepped in the window over its host seconds.

Points are whole epochs times the points an epoch steps (its full batches);
the seconds are the host clock around the window's ``train`` call, which
ends in a synchronize.
"""


def read(r):
    return r.window["points"] / r.window["seconds"]
