"""MiB of card memory that the program's caching allocator reserves on
top with each panorama of the window: (reserved after the window - after
set-up) / panoramas. It reads above 0 while the program keeps what each
panorama allocates (the registration's graphs, captured anew on every
call, with their pools); ``peak_reserved_gib``, read after set-up's fixed
panoramas, carries a few panoramas of it."""
MOVES = "peak_reserved_gib"


def read(trace):
    return trace.setup.get("reserved_growth_mib")
