# blur_algorithms — developer entry points.

PY ?= python

.PHONY: test smoke bench native clean

# CPU test suite (tests/conftest.py forces an 8-device virtual CPU mesh)
test:
	$(PY) -m pytest tests/ -q

# end-to-end check of the main path on one GPU (fails without one)
smoke:
	$(PY) chip_smoke.py

# headline benchmark (one JSON line; needs a GPU)
bench:
	$(PY) bench.py

# native host runtime (reflect-101 / de+interleave / crc32)
native:
	$(MAKE) -C native

clean:
	$(MAKE) -C native clean
