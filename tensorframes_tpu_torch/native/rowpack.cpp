// Native row <-> columnar marshalling kernels.
//
// The reference package's native/rowpack.cpp, unchanged in its code: the
// equivalent of the original system's hand-unrolled hot loops
// (DataOps.scala:63-81 convertFast0 — rows -> tensor buffers;
// DataOps.scala:20-61 convertBackFast0 — tensors -> rows). Here they run
// in C++ against CPython objects feeding numpy, from which the verbs copy
// to the GPU — the host-side half of the host<->device marshalling layer.
//
// Scope mirrors the reference's fast path: scalar numeric columns
// (Double/Float/Int/Long, datatypes.scala:265-267). Vector cells and
// host-only (string/binary) columns take the Python slow path, as the
// reference's reshapeIter slow path did (DataOps.scala:85-101).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

enum DtypeCode { F64 = 0, F32 = 1, I32 = 2, I64 = 3 };

size_t itemsize_for(int code) { return (code == F32 || code == I32) ? 4 : 8; }

// Convert one cell to int64 honouring __index__ (covers numpy integers).
bool cell_to_i64(PyObject* v, int64_t* out) {
  if (PyLong_Check(v)) {
    long long x = PyLong_AsLongLong(v);
    if (x == -1 && PyErr_Occurred()) return false;
    *out = static_cast<int64_t>(x);
    return true;
  }
  PyObject* idx = PyNumber_Index(v);
  if (idx == nullptr) return false;
  long long x = PyLong_AsLongLong(idx);
  Py_DECREF(idx);
  if (x == -1 && PyErr_Occurred()) return false;
  *out = static_cast<int64_t>(x);
  return true;
}

// gather_column(rows, name, code) -> bytearray of len(rows) packed cells.
//
// One pass over a sequence of row dicts: borrow rows[i][name], convert,
// write into a contiguous buffer the wrapper views as a numpy array
// without copying.
PyObject* gather_column(PyObject*, PyObject* args) {
  PyObject* rows;
  const char* name;
  int code;
  if (!PyArg_ParseTuple(args, "Osi", &rows, &name, &code)) return nullptr;
  if (code < F64 || code > I64) {
    PyErr_Format(PyExc_ValueError, "bad dtype code %d", code);
    return nullptr;
  }
  PyObject* fast = PySequence_Fast(rows, "rows must be a sequence");
  if (fast == nullptr) return nullptr;
  const Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  const size_t isz = itemsize_for(code);
  PyObject* out = PyByteArray_FromStringAndSize(nullptr, n * isz);
  PyObject* key = PyUnicode_FromString(name);
  if (out == nullptr || key == nullptr) goto fail;
  {
    char* buf = PyByteArray_AS_STRING(out);
    for (Py_ssize_t i = 0; i < n; ++i) {
      PyObject* row = PySequence_Fast_GET_ITEM(fast, i);  // borrowed
      if (!PyDict_Check(row)) {
        PyErr_Format(PyExc_TypeError, "row %zd is not a dict", (ssize_t)i);
        goto fail;
      }
      PyObject* v = PyDict_GetItemWithError(row, key);  // borrowed
      if (v == nullptr) {
        if (!PyErr_Occurred())
          PyErr_Format(PyExc_KeyError, "row %zd has no column '%s'",
                       (ssize_t)i, name);
        goto fail;
      }
      switch (code) {
        case F64: {
          double d = PyFloat_AsDouble(v);
          if (d == -1.0 && PyErr_Occurred()) goto fail;
          reinterpret_cast<double*>(buf)[i] = d;
          break;
        }
        case F32: {
          double d = PyFloat_AsDouble(v);
          if (d == -1.0 && PyErr_Occurred()) goto fail;
          reinterpret_cast<float*>(buf)[i] = static_cast<float>(d);
          break;
        }
        case I32: {
          int64_t x;
          if (!cell_to_i64(v, &x)) goto fail;
          if (x < INT32_MIN || x > INT32_MAX) {
            PyErr_Format(PyExc_OverflowError,
                         "row %zd column '%s': %lld out of int32 range",
                         (ssize_t)i, name, (long long)x);
            goto fail;
          }
          reinterpret_cast<int32_t*>(buf)[i] = static_cast<int32_t>(x);
          break;
        }
        case I64: {
          int64_t x;
          if (!cell_to_i64(v, &x)) goto fail;
          reinterpret_cast<int64_t*>(buf)[i] = x;
          break;
        }
      }
    }
  }
  Py_DECREF(key);
  Py_DECREF(fast);
  return out;
fail:
  Py_XDECREF(key);
  Py_XDECREF(out);
  Py_DECREF(fast);
  return nullptr;
}

// scatter_rows(names, buffers, codes) -> list of row dicts.
//
// names: tuple of str; buffers: tuple of C-contiguous 1-D buffers (one per
// column, equal lengths); codes: tuple of dtype codes. Builds the whole
// list-of-dicts result in one C pass (the collect() hot loop).
PyObject* scatter_rows(PyObject*, PyObject* args) {
  PyObject *names, *buffers, *codes;
  if (!PyArg_ParseTuple(args, "OOO", &names, &buffers, &codes)) return nullptr;
  if (!PyTuple_Check(names) || !PyTuple_Check(buffers) || !PyTuple_Check(codes)) {
    PyErr_SetString(PyExc_TypeError, "names/buffers/codes must be tuples");
    return nullptr;
  }
  const Py_ssize_t k = PyTuple_GET_SIZE(names);
  if (PyTuple_GET_SIZE(buffers) != k || PyTuple_GET_SIZE(codes) != k) {
    PyErr_SetString(PyExc_ValueError, "names/buffers/codes length mismatch");
    return nullptr;
  }
  if (k == 0) return PyList_New(0);  // zero-column frame: no rows to infer
  Py_buffer* views = new Py_buffer[k];
  int* col_codes = new int[k];
  Py_ssize_t acquired = 0;
  PyObject* result = nullptr;
  Py_ssize_t n = -1;

  for (; acquired < k; ++acquired) {
    PyObject* b = PyTuple_GET_ITEM(buffers, acquired);
    if (PyObject_GetBuffer(b, &views[acquired], PyBUF_C_CONTIGUOUS) != 0)
      goto done;
    long code = PyLong_AsLong(PyTuple_GET_ITEM(codes, acquired));
    if ((code == -1 && PyErr_Occurred()) || code < F64 || code > I64) {
      if (!PyErr_Occurred())
        PyErr_Format(PyExc_ValueError, "bad dtype code %ld", code);
      ++acquired;  // this view was acquired; release it in cleanup
      goto done;
    }
    col_codes[acquired] = static_cast<int>(code);
    const Py_ssize_t rows_here =
        views[acquired].len / (Py_ssize_t)itemsize_for(col_codes[acquired]);
    if (n == -1) {
      n = rows_here;
    } else if (rows_here != n) {
      PyErr_Format(PyExc_ValueError,
                   "column %zd has %zd rows, expected %zd",
                   (ssize_t)acquired, (ssize_t)rows_here, (ssize_t)n);
      ++acquired;
      goto done;
    }
  }

  result = PyList_New(n);
  if (result == nullptr) goto done;
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* row = PyDict_New();
    if (row == nullptr) goto fail_rows;
    PyList_SET_ITEM(result, i, row);  // steals
    for (Py_ssize_t j = 0; j < k; ++j) {
      const char* buf = static_cast<const char*>(views[j].buf);
      PyObject* cell = nullptr;
      switch (col_codes[j]) {
        case F64:
          cell = PyFloat_FromDouble(reinterpret_cast<const double*>(buf)[i]);
          break;
        case F32:
          cell = PyFloat_FromDouble(
              (double)reinterpret_cast<const float*>(buf)[i]);
          break;
        case I32:
          cell = PyLong_FromLong(reinterpret_cast<const int32_t*>(buf)[i]);
          break;
        case I64:
          cell = PyLong_FromLongLong(reinterpret_cast<const int64_t*>(buf)[i]);
          break;
      }
      if (cell == nullptr) goto fail_rows;
      if (PyDict_SetItem(row, PyTuple_GET_ITEM(names, j), cell) != 0) {
        Py_DECREF(cell);
        goto fail_rows;
      }
      Py_DECREF(cell);
    }
  }
  goto done;

fail_rows:
  Py_CLEAR(result);
done:
  for (Py_ssize_t j = 0; j < acquired; ++j) PyBuffer_Release(&views[j]);
  delete[] views;
  delete[] col_codes;
  return result;  // nullptr on error (exception set)
}

// parse_csv(data: bytes, delim: byte, codes: tuple[int]) -> tuple
//
// One native pass over unquoted CSV bytes (the Python wrapper detects
// quoting and takes the csv-module path instead). Per column code:
// F64 -> bytearray of packed doubles (empty field = NaN), I64 ->
// bytearray of packed int64, STR(4) -> list[str]. Rows end at '\n'
// (optional '\r' stripped); a missing trailing newline is fine.
constexpr int STR_CODE = 4;

PyObject* parse_csv(PyObject*, PyObject* args) {
  Py_buffer data;
  int delim_i;
  PyObject* codes_obj;
  if (!PyArg_ParseTuple(args, "y*iO", &data, &delim_i, &codes_obj)) {
    return nullptr;
  }
  const char delim = static_cast<char>(delim_i);
  PyObject* codes_fast =
      PySequence_Fast(codes_obj, "codes must be a sequence");
  if (codes_fast == nullptr) {
    PyBuffer_Release(&data);
    return nullptr;
  }
  const Py_ssize_t ncols = PySequence_Fast_GET_SIZE(codes_fast);
  int* codes = new int[ncols];
  for (Py_ssize_t j = 0; j < ncols; ++j) {
    const long code = PyLong_AsLong(PySequence_Fast_GET_ITEM(codes_fast, j));
    if (code == -1 && PyErr_Occurred()) {
      Py_DECREF(codes_fast);
      delete[] codes;
      PyBuffer_Release(&data);
      return nullptr;
    }
    codes[j] = static_cast<int>(code);
  }
  Py_DECREF(codes_fast);

  // estimate rows (newline count + a possible unterminated last line) so
  // numeric buffers allocate once instead of O(rows) reallocs
  const char* scan = static_cast<const char*>(data.buf);
  const char* scan_end = scan + data.len;
  Py_ssize_t est = (data.len > 0 && scan_end[-1] != '\n') ? 1 : 0;
  for (const char* q = scan; q < scan_end; ++q) {
    if (*q == '\n') ++est;
  }

  // column outputs
  PyObject** outs = new PyObject*[ncols]();
  bool ok = true;
  for (Py_ssize_t j = 0; j < ncols && ok; ++j) {
    outs[j] = (codes[j] == STR_CODE)
                  ? PyList_New(0)
                  : PyByteArray_FromStringAndSize(nullptr, est * 8);
    if (outs[j] == nullptr) ok = false;
  }

  const char* p = static_cast<const char*>(data.buf);
  const char* end = p + data.len;
  char numbuf[64];
  long long nrow = 0;
  while (ok && p < end) {
    // skip blank lines, LF or CRLF (the csv-module fallback drops them)
    if (*p == '\n') { ++p; continue; }
    if (*p == '\r' && p + 1 < end && p[1] == '\n') { p += 2; continue; }
    for (Py_ssize_t j = 0; j < ncols && ok; ++j) {
      const char* f = p;
      while (p < end && *p != delim && *p != '\n') ++p;
      const char* fe = p;
      if (fe > f && fe[-1] == '\r') --fe;
      const size_t flen = static_cast<size_t>(fe - f);
      if (codes[j] == STR_CODE) {
        PyObject* s = PyUnicode_DecodeUTF8(f, static_cast<Py_ssize_t>(flen),
                                           "replace");
        if (s == nullptr || PyList_Append(outs[j], s) != 0) {
          Py_XDECREF(s);
          ok = false;
          break;
        }
        Py_DECREF(s);
      } else {
        if (flen >= sizeof(numbuf)) {
          PyErr_Format(PyExc_ValueError,
                       "csv row %lld col %zd: field too long", nrow, j);
          ok = false;
          break;
        }
        std::memcpy(numbuf, f, flen);
        numbuf[flen] = '\0';
        if (codes[j] == F64) {
          double v;
          if (flen == 0) {
            v = __builtin_nan("");
          } else {
            char* ep = nullptr;
            // PyOS_string_to_double is locale-independent (strtod honours
            // LC_NUMERIC and would reject '0.5' under comma-decimal locales)
            v = PyOS_string_to_double(numbuf, &ep, nullptr);
            if (v == -1.0 && PyErr_Occurred()) PyErr_Clear();
            if (ep != numbuf + flen) {
              PyErr_Format(PyExc_ValueError,
                           "csv row %lld col %zd: bad float %.60s", nrow, j,
                           numbuf);
              ok = false;
              break;
            }
          }
          std::memcpy(PyByteArray_AS_STRING(outs[j]) + nrow * 8, &v, 8);
        } else {  // I64
          char* ep = nullptr;
          errno = 0;
          long long v = strtoll(numbuf, &ep, 10);
          if (errno == ERANGE) {
            PyErr_Format(PyExc_OverflowError,
                         "csv row %lld col %zd: %.60s out of int64 range",
                         nrow, j, numbuf);
            ok = false;
            break;
          }
          if (flen == 0 || ep != numbuf + flen) {
            PyErr_Format(PyExc_ValueError,
                         "csv row %lld col %zd: bad int %.60s", nrow, j,
                         numbuf);
            ok = false;
            break;
          }
          int64_t v64 = static_cast<int64_t>(v);
          std::memcpy(PyByteArray_AS_STRING(outs[j]) + nrow * 8, &v64, 8);
        }
      }
      // advance past the delimiter (not past the newline)
      if (p < end && *p == delim && j + 1 < ncols) ++p;
    }
    if (!ok) break;
    // drop any extra fields beyond the header's columns (the csv-module
    // fallback ignores them too) — without this the leftover text would
    // be re-parsed as phantom rows PAST the preallocated buffers
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;  // consume the newline
    ++nrow;
  }

  // shrink numeric buffers to the actual row count (empty lines skipped)
  for (Py_ssize_t j = 0; j < ncols && ok; ++j) {
    if (codes[j] != STR_CODE && PyByteArray_GET_SIZE(outs[j]) != nrow * 8) {
      if (PyByteArray_Resize(outs[j], nrow * 8) != 0) ok = false;
    }
  }

  PyObject* result = nullptr;
  if (ok) {
    result = PyTuple_New(ncols + 1);
    if (result != nullptr) {
      for (Py_ssize_t j = 0; j < ncols; ++j) {
        PyTuple_SET_ITEM(result, j, outs[j]);  // steals
        outs[j] = nullptr;
      }
      PyTuple_SET_ITEM(result, ncols, PyLong_FromLongLong(nrow));
    }
  }
  for (Py_ssize_t j = 0; j < ncols; ++j) Py_XDECREF(outs[j]);
  delete[] outs;
  delete[] codes;
  PyBuffer_Release(&data);
  return result;
}

// dict_encode(seq) -> (bytearray of int32 first-appearance codes, uniques
// list in first-appearance order).
//
// One hash pass over arbitrary hashable cells (strings are the target:
// aggregate()'s dictionary key encoding). Replaces numpy's sort-based
// np.unique(return_inverse=True) — O(n) dict probes vs O(n log n) string
// comparisons; the caller lexicographically argsorts the K uniques
// (K = distinct groups, tiny) and remaps vectorized.
PyObject* dict_encode(PyObject*, PyObject* args) {
  PyObject* seq;
  if (!PyArg_ParseTuple(args, "O", &seq)) return nullptr;
  PyObject* fast = PySequence_Fast(seq, "dict_encode expects a sequence");
  if (fast == nullptr) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  PyObject* out = PyByteArray_FromStringAndSize(nullptr, n * 4);
  PyObject* table = PyDict_New();
  PyObject* uniques = PyList_New(0);
  bool ok = out != nullptr && table != nullptr && uniques != nullptr;
  if (ok) {
    int32_t* codes = reinterpret_cast<int32_t*>(PyByteArray_AS_STRING(out));
    for (Py_ssize_t i = 0; i < n && ok; ++i) {
      PyObject* v = PySequence_Fast_GET_ITEM(fast, i);  // borrowed
      PyObject* idx = PyDict_GetItemWithError(table, v);  // borrowed
      if (idx != nullptr) {
        codes[i] = static_cast<int32_t>(PyLong_AsLong(idx));
      } else if (PyErr_Occurred()) {
        ok = false;  // unhashable cell — error already set
      } else {
        Py_ssize_t k = PyList_GET_SIZE(uniques);
        if (k >= INT32_MAX) {
          PyErr_SetString(PyExc_OverflowError, "too many distinct keys");
          ok = false;
          break;
        }
        PyObject* kobj = PyLong_FromSsize_t(k);
        if (kobj == nullptr || PyDict_SetItem(table, v, kobj) != 0 ||
            PyList_Append(uniques, v) != 0) {
          Py_XDECREF(kobj);
          ok = false;
          break;
        }
        Py_DECREF(kobj);
        codes[i] = static_cast<int32_t>(k);
      }
    }
  }
  PyObject* result = nullptr;
  if (ok) {
    result = PyTuple_New(2);
    if (result != nullptr) {
      PyTuple_SET_ITEM(result, 0, out);      // steals
      PyTuple_SET_ITEM(result, 1, uniques);  // steals
      out = nullptr;
      uniques = nullptr;
    }
  }
  Py_XDECREF(out);
  Py_XDECREF(uniques);
  Py_XDECREF(table);
  Py_DECREF(fast);
  return result;
}

// stack_cells(cells) -> bytearray of the cells' bytes concatenated.
//
// The ragged map_rows path stacks thousands of small same-shape ndarray
// cells per shape group (np.stack pays per-element numpy dispatch); one
// native pass over the buffer protocol memcpys them. Every cell must be
// C-contiguous with identical itemsize/format/shape — any mismatch
// raises and the wrapper falls back to np.stack.
PyObject* stack_cells(PyObject*, PyObject* args) {
  PyObject* cells;
  if (!PyArg_ParseTuple(args, "O", &cells)) return nullptr;
  PyObject* fast = PySequence_Fast(cells, "cells must be a sequence");
  if (fast == nullptr) return nullptr;
  const Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  if (n == 0) {
    Py_DECREF(fast);
    PyErr_SetString(PyExc_ValueError, "stack_cells needs >= 1 cell");
    return nullptr;
  }
  PyObject* out = nullptr;
  Py_buffer first;
  first.obj = nullptr;
  {
    PyObject* c0 = PySequence_Fast_GET_ITEM(fast, 0);  // borrowed
    if (PyObject_GetBuffer(c0, &first, PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) !=
        0)
      goto fail;
    const Py_ssize_t cell_len = first.len;
    out = PyByteArray_FromStringAndSize(nullptr, n * cell_len);
    if (out == nullptr) goto fail;
    char* buf = PyByteArray_AS_STRING(out);
    std::memcpy(buf, first.buf, cell_len);
    for (Py_ssize_t i = 1; i < n; ++i) {
      PyObject* c = PySequence_Fast_GET_ITEM(fast, i);  // borrowed
      Py_buffer view;
      if (PyObject_GetBuffer(c, &view, PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) !=
          0)
        goto fail;
      bool ok =
          view.len == cell_len && view.itemsize == first.itemsize &&
          view.ndim == first.ndim &&
          ((view.format == nullptr && first.format == nullptr) ||
           (view.format != nullptr && first.format != nullptr &&
            std::strcmp(view.format, first.format) == 0));
      // same byte length is NOT same shape ([2,6] vs [3,4] f32):
      // PyBUF_C_CONTIGUOUS implies ND, so shape arrays are present
      if (ok && view.shape != nullptr && first.shape != nullptr) {
        for (int d = 0; d < view.ndim; ++d)
          if (view.shape[d] != first.shape[d]) {
            ok = false;
            break;
          }
      }
      if (!ok) {
        PyBuffer_Release(&view);
        PyErr_Format(PyExc_ValueError,
                     "cell %zd does not match cell 0's shape/dtype",
                     (ssize_t)i);
        goto fail;
      }
      std::memcpy(buf + i * cell_len, view.buf, cell_len);
      PyBuffer_Release(&view);
    }
  }
  PyBuffer_Release(&first);
  Py_DECREF(fast);
  return out;
fail:
  if (first.obj != nullptr) PyBuffer_Release(&first);
  Py_XDECREF(out);
  Py_DECREF(fast);
  return nullptr;
}

PyMethodDef methods[] = {
    {"dict_encode", dict_encode, METH_VARARGS,
     "dict_encode(seq) -> (bytearray int32 codes, uniques list)"},
    {"stack_cells", stack_cells, METH_VARARGS,
     "stack_cells(cells) -> bytearray of concatenated equal-shape cells"},
    {"gather_column", gather_column, METH_VARARGS,
     "gather_column(rows, name, dtype_code) -> bytearray of packed cells"},
    {"scatter_rows", scatter_rows, METH_VARARGS,
     "scatter_rows(names, buffers, dtype_codes) -> list of row dicts"},
    {"parse_csv", parse_csv, METH_VARARGS,
     "parse_csv(data, delim_byte, codes) -> (*columns, nrows)"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_rowpack",
                         "Native row<->columnar marshalling kernels.", -1,
                         methods};

}  // namespace

PyMODINIT_FUNC PyInit__rowpack(void) { return PyModule_Create(&moduledef); }
