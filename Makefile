# radixhashjoin_tpu — convenience targets (reference parity: Makefile:1-14).
PY ?= python
DATA ?= .contest
SCALE ?= 1

.PHONY: all native test test-all test-slow data run smoke bench clean

all: native

native:
	$(MAKE) -C radixhashjoin_tpu/runtime/native

# fast default suite (slow-marked end-to-end/SPMD tests deselected, pytest.ini)
test:
	$(PY) -m pytest tests/ -q

# the whole suite, including the slow golden/SPMD tests; the persistent
# compilation cache (.jax_cache) keeps repeat runs compile-free
test-all:
	$(PY) -m pytest tests/ -q -m ""

# just the slow tier (golden end-to-end + SPMD mesh tests)
test-slow:
	$(PY) -m pytest tests/ -q -m slow

# a seeded contest workload (radixhashjoin_tpu/datagen.py) with oracle.py's
# answers in $(DATA)/contest.result
data:
	$(PY) -m radixhashjoin_tpu.datagen --out $(DATA) --scale $(SCALE) --result

# the reference's benchmark contract: init+work on stdin, diff stdout
run: native data
	cd $(DATA) && cat contest.init contest.work | \
	  time $(PY) -m radixhashjoin_tpu | diff - contest.result && \
	  echo "exact match"

# the engine's main path on an NVIDIA GPU, every answer checked
smoke:
	$(PY) chip_smoke.py

bench:
	$(PY) bench.py

clean:
	$(MAKE) -C radixhashjoin_tpu/runtime/native clean
