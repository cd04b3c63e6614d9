# Developer entry points (the reference's Makefile counterpart).
# The C++ runtime builds itself on demand into ~/.cache/qvz_tpu; `make
# native` forces a rebuild, `make test` runs the suite, `make bench`
# prints the one-line benchmark JSON.

PY ?= python
CXX ?= g++
NATIVE_DIR := qvz_tpu/native
SAN_FLAGS := -O1 -g -std=c++17 -fno-omit-frame-pointer \
  -I$(NATIVE_DIR) \
  $(NATIVE_DIR)/qvz_rt.cpp $(NATIVE_DIR)/sanitize_harness.cpp

.PHONY: all native test test-fast smoke bench tsan asan clean

all: native

native:
	rm -rf $${QVZ_TPU_CACHE:-$$HOME/.cache/qvz_tpu}
	$(PY) -c "import qvz_tpu.native as n; n.load(); print('native runtime built')"

test:
	$(PY) -m pytest tests/ -q

test-fast:
	$(PY) -m pytest tests/ -q -x --ignore=tests/test_reference_live.py

# Device-path check on a GPU (fails without one): chip_smoke.py.
smoke:
	$(PY) chip_smoke.py

bench:
	$(PY) bench.py

# Whole-process sanitizer builds of the native runtime + threaded harness
# (ctypes-dlopen'd .so can't be TSAN-instrumented reliably, so these link
# qvz_rt.cpp directly into an executable that drives every threaded path:
# design parallel_for, kmeans row threads, concurrent well_jump, per-shard
# encode/decode threads). DESIGN.md's thread-safety claim cites these.
tsan:
	mkdir -p build
	$(CXX) -fsanitize=thread $(SAN_FLAGS) -o build/qvz_tsan
	TSAN_OPTIONS="halt_on_error=1" ./build/qvz_tsan

asan:
	mkdir -p build
	$(CXX) -fsanitize=address,undefined $(SAN_FLAGS) -o build/qvz_asan
	ASAN_OPTIONS="detect_leaks=1" ./build/qvz_asan

clean:
	rm -rf $${QVZ_TPU_CACHE:-$$HOME/.cache/qvz_tpu}
	find . -name __pycache__ -type d -exec rm -rf {} +
