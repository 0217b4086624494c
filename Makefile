# polar-tpu build/test driver (the reference's 28-line Makefile analog).
#
#   make native    - build the C construction/compiler extension into build/
#   make test      - run the test suite (CPU backend, 8 virtual devices)
#   make bench     - run the north-star benchmark (needs an NVIDIA GPU)
#   make smoke     - run chip_smoke.py (needs an NVIDIA GPU)
#   make waterfall - run the default BER campaign (the reference's `make test`)
#   make fuzz      - randomized parity fuzz vs the reference oracle
#   make oracle    - build the reference-based golden-test oracle
#   make clean

PY ?= python

.PHONY: all native test bench smoke waterfall fuzz oracle clean

all: native

native:
	$(PY) -c "from polar_tpu.code.native import build_native; print(build_native())"

test:
	$(PY) -m pytest tests/ -q

bench:
	$(PY) bench.py

smoke:
	$(PY) chip_smoke.py

waterfall:
	$(PY) scripts/waterfall.py --m 14 --rate 0.5 --no-throughput

fuzz:
	$(PY) scripts/fuzz_parity.py --iters 200

oracle:
	$(PY) -c "import sys; sys.path.insert(0, 'tests'); import oracle; print(oracle.oracle_path())"

clean:
	rm -rf build tests/oracle/build .jax_cache
