"""Device milliseconds a step in float32 real matrix products: the traced
seconds of every kernel whose name holds cuBLAS's float32 GEMM symbols
(``gemm_f32f32`` of its FFMA ``xmma`` kernels, ``simt_sgemm`` of CUTLASS's
SIMT ones, which the ViT's and the Swin trunk's linear layers and their
attention's batched products ran on), its split-K reduction
(``splitKreduce``) and matrix-vector helpers (``gemv``), or the port's own
split-TF32 GEMM (``linear_gemm``), over the traced steps. cuDNN's FFT
convolutions' complex products (``cf32``) and its implicit-GEMM
convolutions (``implicit_gemm``) are left out. It reads the same work
whichever of them implements it."""

SYMBOLS = ("gemm_f32f32", "simt_sgemm", "splitKreduce", "gemv", "linear_gemm")
LEFT_OUT = ("cf32", "implicit_gemm")


def read(run):
    t = run.get("trace")
    if not t:
        return None
    secs = sum(v[1] for k, v in t["by_name"].items()
               if any(s in k for s in SYMBOLS) and not any(s in k for s in LEFT_OUT))
    if secs <= 0:
        return None
    return 1e3 * secs / t["steps"]
