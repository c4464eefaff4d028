"""The harness: finds what ``BENCHMARK.json`` names, drives the system
under test, reads its trace and judges its output (`cli.run_cell`)."""
