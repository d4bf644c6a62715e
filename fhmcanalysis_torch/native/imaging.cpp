// Native priority-flood watershed for 2-D lnPI phase identification.
//
// The reference uses skimage.morphology.watershed (C, pore_hist.pyx:423);
// this is the equivalent native component for the rebuild (the PyTorch
// port's copy of the JAX package's native/imaging.cpp).  The flood
// order mirrors fhmcanalysis_torch/two_dim/imaging.py:watershed exactly
// (min-heap on (elevation, insertion counter), seeds pushed in row-major
// order, neighbors in the caller's offset order) so native and Python
// paths produce bit-identical label maps.

#define PY_SSIZE_T_CLEAN
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <Python.h>
#include <numpy/arrayobject.h>

#include <cstdint>
#include <queue>
#include <vector>

namespace {

struct Node {
    double value;
    std::int64_t counter;
    std::int32_t i, j;
};

struct NodeGreater {
    bool operator()(const Node &a, const Node &b) const {
        if (a.value != b.value) return a.value > b.value;
        return a.counter > b.counter;
    }
};

PyObject *watershed(PyObject *, PyObject *args) {
    PyObject *image_o, *markers_o, *mask_o, *offs_o;
    if (!PyArg_ParseTuple(args, "OOOO", &image_o, &markers_o, &mask_o, &offs_o)) return nullptr;

    PyArrayObject *image = reinterpret_cast<PyArrayObject *>(
        PyArray_FROM_OTF(image_o, NPY_FLOAT64, NPY_ARRAY_IN_ARRAY));
    PyArrayObject *markers = reinterpret_cast<PyArrayObject *>(
        PyArray_FROM_OTF(markers_o, NPY_INT64, NPY_ARRAY_IN_ARRAY));
    PyArrayObject *mask = reinterpret_cast<PyArrayObject *>(
        PyArray_FROM_OTF(mask_o, NPY_BOOL, NPY_ARRAY_IN_ARRAY));
    PyArrayObject *offs = reinterpret_cast<PyArrayObject *>(
        PyArray_FROM_OTF(offs_o, NPY_INT64, NPY_ARRAY_IN_ARRAY));
    if (!image || !markers || !mask || !offs) {
        Py_XDECREF(image); Py_XDECREF(markers); Py_XDECREF(mask); Py_XDECREF(offs);
        return nullptr;
    }
    if (PyArray_NDIM(image) != 2 || PyArray_NDIM(markers) != 2 || PyArray_NDIM(mask) != 2 ||
        PyArray_NDIM(offs) != 2 || PyArray_DIM(offs, 1) != 2) {
        PyErr_SetString(PyExc_ValueError, "watershed expects image/markers/mask [H,W] and offsets [K,2]");
        Py_DECREF(image); Py_DECREF(markers); Py_DECREF(mask); Py_DECREF(offs);
        return nullptr;
    }

    const npy_intp H = PyArray_DIM(image, 0), W = PyArray_DIM(image, 1);
    if (PyArray_DIM(markers, 0) != H || PyArray_DIM(markers, 1) != W ||
        PyArray_DIM(mask, 0) != H || PyArray_DIM(mask, 1) != W) {
        PyErr_SetString(PyExc_ValueError, "watershed: image, markers and mask must share the same [H,W]");
        Py_DECREF(image); Py_DECREF(markers); Py_DECREF(mask); Py_DECREF(offs);
        return nullptr;
    }
    const double *img = static_cast<const double *>(PyArray_DATA(image));
    const std::int64_t *mrk = static_cast<const std::int64_t *>(PyArray_DATA(markers));
    const npy_bool *msk = static_cast<const npy_bool *>(PyArray_DATA(mask));
    const std::int64_t *off = static_cast<const std::int64_t *>(PyArray_DATA(offs));
    const npy_intp K = PyArray_DIM(offs, 0);

    npy_intp dims[2] = {H, W};
    PyObject *labels_o = PyArray_SimpleNew(2, dims, NPY_INT64);
    if (!labels_o) {
        Py_DECREF(image); Py_DECREF(markers); Py_DECREF(mask); Py_DECREF(offs);
        return nullptr;
    }
    std::int64_t *lab = static_cast<std::int64_t *>(
        PyArray_DATA(reinterpret_cast<PyArrayObject *>(labels_o)));

    // The flood touches only raw buffers from here on: release the GIL so
    // the host pipelines can thread the per-state segmentation loop
    // (pore/joint sweeps run S independent watersheds per batch).  Heap
    // growth can throw std::bad_alloc; a C++ exception escaping while the
    // GIL is released aborts the process, so the flood body is fenced and
    // the error re-raised as a Python exception after the GIL returns.
    bool flood_oom = false;
    Py_BEGIN_ALLOW_THREADS;
    try {
    // Precompute linear neighbor deltas and the interior margin: cells
    // farther than the largest offset from every border can skip the
    // per-neighbor bounds checks (the offsets are a footprint
    // neighborhood — up to 26 entries for the pore/joint 3x9 — so the
    // neighbor scan is the flood's hot loop).  Push order is untouched:
    // labels stay bit-identical to the Python heapq path.
    std::vector<npy_intp> dlin(K);
    npy_intp m_i = 0, m_j = 0;
    for (npy_intp k = 0; k < K; ++k) {
        const npy_intp di = off[2 * k], dj = off[2 * k + 1];
        dlin[k] = di * W + dj;
        if (di > m_i) m_i = di; if (-di > m_i) m_i = -di;
        if (dj > m_j) m_j = dj; if (-dj > m_j) m_j = -dj;
    }
    std::priority_queue<Node, std::vector<Node>, NodeGreater> heap;
    std::int64_t counter = 0;
    for (npy_intp i = 0; i < H; ++i)
        for (npy_intp j = 0; j < W; ++j) {
            const npy_intp p = i * W + j;
            lab[p] = mrk[p];
            if (mrk[p] > 0 && msk[p])
                heap.push({img[p], counter++, static_cast<std::int32_t>(i), static_cast<std::int32_t>(j)});
        }

    while (!heap.empty()) {
        Node n = heap.top();
        heap.pop();
        const npy_intp p0 = static_cast<npy_intp>(n.i) * W + n.j;
        const std::int64_t l = lab[p0];
        if (n.i >= m_i && n.i < H - m_i && n.j >= m_j && n.j < W - m_j) {
            for (npy_intp k = 0; k < K; ++k) {
                const npy_intp p = p0 + dlin[k];
                if (msk[p] && lab[p] == 0) {
                    lab[p] = l;
                    heap.push({img[p], counter++,
                               static_cast<std::int32_t>(n.i + off[2 * k]),
                               static_cast<std::int32_t>(n.j + off[2 * k + 1])});
                }
            }
        } else {
            for (npy_intp k = 0; k < K; ++k) {
                const npy_intp ni = n.i + off[2 * k], nj = n.j + off[2 * k + 1];
                if (ni >= 0 && ni < H && nj >= 0 && nj < W) {
                    const npy_intp p = ni * W + nj;
                    if (msk[p] && lab[p] == 0) {
                        lab[p] = l;
                        heap.push({img[p], counter++,
                                   static_cast<std::int32_t>(ni), static_cast<std::int32_t>(nj)});
                    }
                }
            }
        }
    }
    for (npy_intp p = 0; p < H * W; ++p)
        if (!msk[p]) lab[p] = 0;
    } catch (const std::bad_alloc &) {
        flood_oom = true;
    }
    Py_END_ALLOW_THREADS;

    Py_DECREF(image); Py_DECREF(markers); Py_DECREF(mask); Py_DECREF(offs);
    if (flood_oom) {
        Py_DECREF(labels_o);
        return PyErr_NoMemory();
    }
    return labels_o;
}

PyMethodDef Methods[] = {
    {"watershed", watershed, METH_VARARGS,
     "watershed(image f64[H,W], markers i64[H,W], mask bool[H,W], offsets i64[K,2]) -> labels i64[H,W]"},
    {nullptr, nullptr, 0, nullptr},
};

struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_fhmc_imaging", "Native watershed for 2-D lnPI segmentation", -1, Methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__fhmc_imaging(void) {
    import_array();
    return PyModule_Create(&moduledef);
}
