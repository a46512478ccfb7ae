"""The benchmark's yardstick: peaks, operation and byte counts, the
profile readers, the tile generator and the comparison that decides
`correct`. Later PRs to the program cannot change any of it."""
