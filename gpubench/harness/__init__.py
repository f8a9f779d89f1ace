"""The benchmark's general machinery: finding a cell's files by name
(`spec`), making its inputs from the seed (`inputs`), the measured window and
the result line (`window`), reading the profiler's device records (`profile`)
and the comparisons that decide `correct` (`compare`)."""
