"""``batchnorm_ms`` reads cuDNN's, ATen's and the port's BatchNorm kernels,
NCHW and channels-last, as the same work, and leaves out cuDNN's inference
kernel."""

import pytest

from perfbench.manifest import reader


def test_batchnorm_ms_sums_every_training_batchnorm_kernel_a_step():
    by_name = {
        "void cudnn::bn_fw_tr_1C11_kernel_NCHW<float, float, int, 512, true, 1, true>": [8, 0.02],
        "void cudnn::bn_bw_1C11_kernel_new<float, float, float2, 512, true, 1>": [8, 0.04],
        "void at::native::batch_norm_collect_statistics_kernel<...>": [1, 0.001],
        "void (anonymous namespace)::batchnorm_fwd_kernel<float4>(...)": [4, 0.002],
        "void (anonymous namespace)::batchnorm_bwd_kernel<float4>(...)": [4, 0.003],
        "void (anonymous namespace)::batchnorm_fwd_rows_kernel<float4>(...)": [2, 0.004],
        "void (anonymous namespace)::batchnorm_bwd_rows_kernel<float4>(...)": [2, 0.005],
        "void cudnn::bn_fw_tr_1C11_singleread<float, 512, true, 1, 2, 0>(...)": [1, 0.006],
        "void cudnn::batchnorm_fwtr_nhwc_semiPersist<float, float, float, 512>(...)": [1, 0.007],
        "void cudnn::batchnorm_bwtr_nhwc_semiPersist<float, float, float, 512>(...)": [1, 0.008],
        "void cudnn::bn_fw_inf_1C11_kernel_NCHW<float, float, true, 1>": [2, 0.5],
        "maxstyle_stats_kernel": [4, 0.5],
    }
    run = {"trace": {"steps": 4, "by_name": by_name}}
    assert reader("batchnorm_ms")(run) == pytest.approx(1e3 * 0.096 / 4)


def test_batchnorm_ms_finds_nothing_without_a_trace_or_a_batchnorm_kernel():
    read = reader("batchnorm_ms")
    assert read({}) is None
    assert read({"trace": {"steps": 2, "by_name": {"maxstyle_bwd_kernel": [3, 1e-3]}}}) is None
