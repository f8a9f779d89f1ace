"""One module a kind of unit: what a request, a sweep or a step does through
the port's public entry. A workload file names its driver; each driver
defines `Cell`."""
