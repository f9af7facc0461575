# the harness's own output directory (git-ignored) may hold a copy of the
# checkout for a proof run; its tests are not this checkout's
collect_ignore = ["out"]
