/* Fast whitespace-delimited numeric table reader.
 *
 * Native replacement for the np.loadtxt calls on window .dat / colMat /
 * extMom files in the patching pipeline (reference fhmc_patch.pyx:472-473,
 * chkpt_patch.pyx:437-441, feasst_patch.pyx:222-235).  Production trees
 * hold 18+ windows x several checkpoint files x ~100+ columns; np.loadtxt
 * is the dominant host cost there.  This module slurps the file once and
 * parses with strtod, ~20-40x faster.
 *
 * Exposes: read_table(path, comment='#') -> float64 ndarray [rows, cols].
 * Rows must all have the same column count (ragged input raises).
 */

#define PY_SSIZE_T_CLEAN
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION

#include <Python.h>
#include <numpy/arrayobject.h>

#include <cerrno>
#include <charconv>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

static PyObject *read_table(PyObject *self, PyObject *args, PyObject *kwargs) {
    const char *path = nullptr;
    const char *comment = "#";
    static const char *kwlist[] = {"path", "comment", nullptr};
    if (!PyArg_ParseTupleAndKeywords(args, kwargs, "s|s", const_cast<char **>(kwlist), &path, &comment)) {
        return nullptr;
    }

    FILE *f = std::fopen(path, "rb");
    if (!f) {
        PyErr_Format(PyExc_OSError, "cannot open %s: %s", path, std::strerror(errno));
        return nullptr;
    }
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::string buf;
    buf.resize(static_cast<size_t>(size) + 1);
    size_t got = std::fread(&buf[0], 1, static_cast<size_t>(size), f);
    std::fclose(f);
    buf[got] = '\0';

    std::vector<double> values;
    values.reserve(1 << 16);
    Py_ssize_t ncols = -1;
    Py_ssize_t nrows = 0;
    const char comment_ch = comment[0];

    char *p = &buf[0];
    char *endbuf = p + got;
    while (p < endbuf) {
        // skip leading spaces/tabs
        while (p < endbuf && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
        if (p >= endbuf) break;
        if (*p == '\n') { p++; continue; }
        if (*p == comment_ch) {
            while (p < endbuf && *p != '\n') p++;
            continue;
        }
        // parse one data line (std::from_chars: locale-free, ~5x strtod)
        Py_ssize_t cols = 0;
        while (p < endbuf && *p != '\n') {
            double v;
            auto res = std::from_chars(p, endbuf, v);
            if (res.ec != std::errc() || res.ptr == p) {
                PyErr_Format(PyExc_ValueError, "non-numeric token in %s at row %zd", path, (Py_ssize_t)nrows);
                return nullptr;
            }
            values.push_back(v);
            cols++;
            p = const_cast<char *>(res.ptr);
            while (p < endbuf && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
        }
        if (p < endbuf) p++;  // consume '\n'
        if (ncols < 0) {
            ncols = cols;
        } else if (cols != ncols) {
            PyErr_Format(PyExc_ValueError, "ragged row %zd in %s: %zd columns, expected %zd",
                         (Py_ssize_t)nrows, path, (Py_ssize_t)cols, (Py_ssize_t)ncols);
            return nullptr;
        }
        nrows++;
    }

    if (ncols < 0) ncols = 0;
    npy_intp dims[2] = {nrows, ncols};
    PyObject *arr = PyArray_SimpleNew(2, dims, NPY_FLOAT64);
    if (!arr) return nullptr;
    if (!values.empty()) {
        std::memcpy(PyArray_DATA(reinterpret_cast<PyArrayObject *>(arr)), values.data(),
                    values.size() * sizeof(double));
    }
    return arr;
}

static PyMethodDef Methods[] = {
    {"read_table", reinterpret_cast<PyCFunction>(read_table), METH_VARARGS | METH_KEYWORDS,
     "read_table(path, comment='#') -> float64 ndarray [rows, cols]"},
    {nullptr, nullptr, 0, nullptr},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_fhmc_native", "Fast table parsing for FHMC window files", -1, Methods,
};

PyMODINIT_FUNC PyInit__fhmc_native(void) {
    import_array();
    return PyModule_Create(&moduledef);
}
