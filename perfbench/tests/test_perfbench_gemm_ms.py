"""``gemm_ms`` reads cuBLAS's float32 GEMMs and the port's split-TF32 GEMM
as the same work, and leaves out cuDNN's FFT and implicit-GEMM
convolutions."""

import pytest

from perfbench.manifest import reader


def test_gemm_ms_sums_every_float32_real_gemm_kernel_a_step():
    by_name = {
        "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x8_stage3_warpsize1x4x1_ffma": [8, 0.3],
        "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x8_stage3": [8, 0.2],
        "cutlass_80_simt_sgemm_128x256_8x4_nt_align1": [4, 0.05],
        "void cublasLt::splitKreduce_kernel<32, 16, int, float, float, float>(...)": [2, 0.001],
        "void gemv2T_kernel_val<int, int, float, float, float, float, 128, 16, 4, 4>(...)": [2, 0.002],
        "void (anonymous namespace)::linear_gemm_kernel<144>(...)": [6, 0.004],
        "sm80_xmma_cgemm_cf32cf32_cf32cf32_f32_nn_n_tilesize32x32x8": [4, 0.5],
        "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs": [4, 0.5],
        "void (anonymous namespace)::batchnorm_fwd_kernel<float4>(...)": [4, 0.5],
    }
    run = {"trace": {"steps": 4, "by_name": by_name}}
    assert reader("gemm_ms")(run) == pytest.approx(1e3 * 0.557 / 4)


def test_gemm_ms_finds_nothing_without_a_trace_or_a_gemm_kernel():
    read = reader("gemm_ms")
    assert read({}) is None
    by_name = {"sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs": [3, 1e-3],
               "sm80_xmma_cgemm_cf32cf32_cf32cf32_f32_nn_n": [3, 1e-3]}
    assert read({"trace": {"steps": 2, "by_name": by_name}}) is None
