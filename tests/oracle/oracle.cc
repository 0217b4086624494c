// Test-only golden oracle for parity tests.
//
// This program is NOT part of the polar_tpu framework. It links the
// UNMODIFIED reference headers (mounted read-only at /root/reference,
// included via -I by the build in tests/conftest.py) and exposes their
// behavior over a tiny stdin/stdout binary protocol, so the Python test
// suite can check the framework bit-exactly against the reference:
// frozen-mask construction, Fast-SSC program compilation, systematic and
// non-systematic encoding, and int8 SIMD Fast-SSC decoding.
//
// Array wire format: int8/uint8 elements. Lane-batched arrays use the
// reference's interleaved lane-major layout (element i of frame k at
// buf[W*i + k], see /root/reference/testbench.cc:72,92-93).
//
// Commands:
//   width                      -> ascii SIMD lane count W
//   freezek  <M> <K> <pe>      -> N mask bytes (PolarCodeConst0)
//   freezeth <M> <pe> <th>     -> N mask bytes (PolarFreezer)
//   progcompile <M>            (stdin: N mask)        -> program bytes
//   encode   <M> <systematic>  (stdin: N mask, W*K msg) -> W*N codeword
//   decode   <M>               (stdin: N mask, W*N llr) -> W*K message
//   widthf                     -> ascii float SIMD lane count WF
//   decodef  <M>               (stdin: N mask, WF*N float32 llr)
//                              -> WF*K float32 message  (the testbench's
//                                 float code_type ablation, testbench.cc:49-53)

#include <cassert>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <chrono>
#include <string>
#include <vector>
#include <algorithm>

#include "simd.hh"
#include "polar_helper.hh"
#include "polar_compiler.hh"
#include "polar_decoder.hh"
#include "polar_encoder.hh"
#include "polar_freezer.hh"

#ifdef __AVX2__
static const int SIZEOF_SIMD = 32;
#else
static const int SIZEOF_SIMD = 16;
#endif
typedef int8_t code_type;
static const int W = SIZEOF_SIMD / sizeof(code_type);
typedef SIMD<code_type, W> simd_type;

static const int MIN_M = 1, MAX_M = 18;

static void read_exact(void *buf, size_t n) {
	if (std::fread(buf, 1, n, stdin) != n) {
		std::fprintf(stderr, "oracle: short read (%zu bytes expected)\n", n);
		std::exit(2);
	}
}

static void write_exact(const void *buf, size_t n) {
	if (std::fwrite(buf, 1, n, stdout) != n) {
		std::fprintf(stderr, "oracle: short write\n");
		std::exit(2);
	}
}

static int count_info(const uint8_t *frozen, int n) {
	int k = 0;
	for (int i = 0; i < n; ++i)
		k += !frozen[i];
	return k;
}

// The reference kernels use aligned SIMD loads; buffers must be allocated
// at sizeof(simd_type) alignment (testbench.cc:72,92-93).
static code_type *alloc_lanes(size_t elems) {
	return reinterpret_cast<code_type *>(
		aligned_alloc(sizeof(simd_type), sizeof(simd_type) * elems));
}

template <int M>
static void run_encode(const uint8_t *frozen, bool systematic) {
	const int N = 1 << M;
	const int K = count_info(frozen, N);
	code_type *message = alloc_lanes(K), *codeword = alloc_lanes(N);
	read_exact(message, size_t(W) * K);
	if (systematic) {
		PolarSysEnc<simd_type, M> enc;
		enc(reinterpret_cast<simd_type *>(codeword),
		    reinterpret_cast<simd_type *>(message), frozen);
	} else {
		PolarEncoder<simd_type, M> enc;
		enc(reinterpret_cast<simd_type *>(codeword),
		    reinterpret_cast<simd_type *>(message), frozen);
	}
	write_exact(codeword, size_t(W) * N);
	free(message);
	free(codeword);
}

template <int M>
static void run_decode(const uint8_t *frozen) {
	const int N = 1 << M;
	const int K = count_info(frozen, N);
	std::vector<uint8_t> program(4 * size_t(N) + 16);
	PolarCompiler compile;
	int plen = compile(program.data(), frozen, M);
	assert(size_t(plen) <= program.size());
	code_type *llr = alloc_lanes(N), *message = alloc_lanes(K);
	read_exact(llr, size_t(W) * N);
	auto *decode = reinterpret_cast<PolarDecoder<simd_type, M> *>(
		aligned_alloc(sizeof(simd_type), sizeof(PolarDecoder<simd_type, M>)));
	(*decode)(reinterpret_cast<simd_type *>(message),
	          reinterpret_cast<simd_type *>(llr), program.data());
	free(decode);
	write_exact(message, size_t(W) * K);
	free(llr);
	free(message);
}

// Float-path decode (the reference's `typedef float code_type` ablation,
// testbench.cc:49-53): PolarHelper<SIMD<float,WF>> generic min-sum.
static const int WF = SIZEOF_SIMD / sizeof(float);
typedef SIMD<float, WF> fsimd_type;

template <int M>
static void run_decodef(const uint8_t *frozen) {
	const int N = 1 << M;
	const int K = count_info(frozen, N);
	std::vector<uint8_t> program(4 * size_t(N) + 16);
	PolarCompiler compile;
	int plen = compile(program.data(), frozen, M);
	assert(size_t(plen) <= program.size());
	float *llr = reinterpret_cast<float *>(
		aligned_alloc(sizeof(fsimd_type), sizeof(fsimd_type) * N));
	float *message = reinterpret_cast<float *>(
		aligned_alloc(sizeof(fsimd_type), sizeof(fsimd_type) * K));
	read_exact(llr, sizeof(float) * size_t(WF) * N);
	auto *decode = reinterpret_cast<PolarDecoder<fsimd_type, M> *>(
		aligned_alloc(sizeof(fsimd_type), sizeof(PolarDecoder<fsimd_type, M>)));
	(*decode)(reinterpret_cast<fsimd_type *>(message),
	          reinterpret_cast<fsimd_type *>(llr), program.data());
	free(decode);
	write_exact(message, sizeof(float) * size_t(WF) * K);
	free(llr);
	free(message);
}

template <int M>
static void run_bench(const uint8_t *frozen, int iters) {
	// Reference decode throughput on this host (frames/s), timed like
	// testbench.cc:170-174 but over many iterations; prints ascii.
	const int N = 1 << M;
	const int K = count_info(frozen, N);
	std::vector<uint8_t> program(4 * size_t(N) + 16);
	PolarCompiler compile;
	int plen = compile(program.data(), frozen, M);
	assert(size_t(plen) <= program.size());
	code_type *llr = alloc_lanes(N), *message = alloc_lanes(K);
	std::srand(42);
	for (size_t i = 0; i < size_t(W) * N; ++i)
		llr[i] = (std::rand() % 255) - 127;
	auto *decode = reinterpret_cast<PolarDecoder<simd_type, M> *>(
		aligned_alloc(sizeof(simd_type), sizeof(PolarDecoder<simd_type, M>)));
	auto start = std::chrono::steady_clock::now();
	for (int it = 0; it < iters; ++it)
		(*decode)(reinterpret_cast<simd_type *>(message),
		          reinterpret_cast<simd_type *>(llr), program.data());
	auto end = std::chrono::steady_clock::now();
	double sec = std::chrono::duration<double>(end - start).count();
	std::printf("%.1f\n", double(W) * iters / sec);
	free(decode);
	free(llr);
	free(message);
}

template <int M>
static void run_freezek(int K, long double pe) {
	const int N = 1 << M;
	std::vector<uint8_t> frozen(N);
	auto *freeze = new PolarCodeConst0<M>;
	(*freeze)(frozen.data(), M, K, pe);
	delete freeze;
	write_exact(frozen.data(), N);
}

#define DISPATCH_M(fn, ...) do { \
	switch (M) { \
	case 1: fn<1>(__VA_ARGS__); break; \
	case 2: fn<2>(__VA_ARGS__); break; \
	case 3: fn<3>(__VA_ARGS__); break; \
	case 4: fn<4>(__VA_ARGS__); break; \
	case 5: fn<5>(__VA_ARGS__); break; \
	case 6: fn<6>(__VA_ARGS__); break; \
	case 7: fn<7>(__VA_ARGS__); break; \
	case 8: fn<8>(__VA_ARGS__); break; \
	case 9: fn<9>(__VA_ARGS__); break; \
	case 10: fn<10>(__VA_ARGS__); break; \
	case 11: fn<11>(__VA_ARGS__); break; \
	case 12: fn<12>(__VA_ARGS__); break; \
	case 13: fn<13>(__VA_ARGS__); break; \
	case 14: fn<14>(__VA_ARGS__); break; \
	case 15: fn<15>(__VA_ARGS__); break; \
	case 16: fn<16>(__VA_ARGS__); break; \
	case 17: fn<17>(__VA_ARGS__); break; \
	case 18: fn<18>(__VA_ARGS__); break; \
	default: std::fprintf(stderr, "oracle: unsupported M=%d\n", M); std::exit(2); \
	} \
} while (0)

int main(int argc, char **argv) {
	if (argc < 2) {
		std::fprintf(stderr, "usage: oracle <cmd> ...\n");
		return 2;
	}
	std::string cmd = argv[1];
	if (cmd == "width") {
		std::printf("%d\n", W);
		return 0;
	}
	if (cmd == "widthf") {
		std::printf("%d\n", WF);
		return 0;
	}
	int M = argc > 2 ? std::atoi(argv[2]) : 0;
	if (M < MIN_M || M > MAX_M) {
		std::fprintf(stderr, "oracle: bad M\n");
		return 2;
	}
	const int N = 1 << M;
	if (cmd == "freezek") {
		int K = std::atoi(argv[3]);
		long double pe = strtold(argv[4], nullptr);
		DISPATCH_M(run_freezek, K, pe);
	} else if (cmd == "freezeth") {
		long double pe = strtold(argv[3], nullptr);
		long double th = strtold(argv[4], nullptr);
		std::vector<uint8_t> frozen(N);
		PolarFreezer freeze;
		freeze(frozen.data(), M, pe, th);
		write_exact(frozen.data(), N);
	} else if (cmd == "progcompile") {
		std::vector<uint8_t> frozen(N), program(4 * size_t(N) + 16);
		read_exact(frozen.data(), N);
		PolarCompiler compile;
		int len = compile(program.data(), frozen.data(), M);
		assert(size_t(len) <= program.size());
		write_exact(program.data(), len);
	} else if (cmd == "encode") {
		bool systematic = std::atoi(argv[3]) != 0;
		std::vector<uint8_t> frozen(N);
		read_exact(frozen.data(), N);
		DISPATCH_M(run_encode, frozen.data(), systematic);
	} else if (cmd == "decode") {
		std::vector<uint8_t> frozen(N);
		read_exact(frozen.data(), N);
		DISPATCH_M(run_decode, frozen.data());
	} else if (cmd == "decodef") {
		std::vector<uint8_t> frozen(N);
		read_exact(frozen.data(), N);
		DISPATCH_M(run_decodef, frozen.data());
	} else if (cmd == "bench") {
		int iters = argc > 3 ? std::atoi(argv[3]) : 10000;
		std::vector<uint8_t> frozen(N);
		read_exact(frozen.data(), N);
		DISPATCH_M(run_bench, frozen.data(), iters);
	} else {
		std::fprintf(stderr, "oracle: unknown command %s\n", cmd.c_str());
		return 2;
	}
	return 0;
}
