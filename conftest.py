# Directories that `.gitignore` lists and that may hold copies of the repo
# (an unpacked parent commit, build outputs, results fetched back from a card
# run). Test files there share basenames with `tests/` and `hybench/`, and
# collecting them makes pytest refuse the real modules as import mismatches.
collect_ignore = ["archive", "build", "chiprun_out"]
